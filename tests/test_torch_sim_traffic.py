"""Open-loop traffic in the port (``repro_torch.sim.traffic``,
``metrics``, ``Simulation(..., traffic=...)``) against the JAX package's
on the CPU, after tests/test_traffic.py and tests/test_topology.py's retry
cases: the seeded arrival stream, the retry backoff, whole ``run_traffic``
runs under every strategy (admission gate, retries, churn samples, a node
failure) with ``TrafficResult``, ``SimResult`` and ``action_log`` equal,
the metric functions on seeded event streams, and the traffic goldens of
tests/data/traffic_goldens.json on the port.  Every seed is fixed."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as R  # noqa: E402
import repro.sim.traffic as RT  # noqa: E402
import repro.workloads as RW  # noqa: E402
import repro_torch.sim as P  # noqa: E402
import repro_torch.sim.traffic as PT  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402

CPU = "cpu"
STRATEGIES = ["orig", "cws", "wow"]
_DATA = os.path.join(os.path.dirname(__file__), "data")
with open(os.path.join(_DATA, "traffic_goldens.json")) as _f:
    TRAFFIC_GOLDENS = json.load(_f)["scenarios"]
with open(os.path.join(_DATA, "churn_goldens.json")) as _f:
    CHURN_GOLDENS = json.load(_f)["scenarios"]


def _traffic(pkg, seed=0, n_arrivals=8, max_backlog=None, process="poisson",
             rate=0.05, retry=None):
    """tests/test_traffic.py::_small_traffic for either package, with an
    optional retry policy on the first tenant."""
    policy = pkg.RetryPolicy(**retry) if retry else None
    return pkg.TrafficConfig(
        tenants=(pkg.TenantSpec("alice", weight=2.0,
                                workflows=("chain", "fork"), scale=0.05,
                                slo=300.0, retry=policy),
                 pkg.TenantSpec("bob", weight=1.0, workflows=("group",),
                                scale=0.05, slo=400.0)),
        rate=rate, n_arrivals=n_arrivals, process=process,
        max_backlog=max_backlog, window=30.0, seed=seed)


@pytest.mark.parametrize("process", ["poisson", "diurnal"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_arrival_schedule_equals_the_reference(seed, process):
    for rate in (0.05, 1.3):
        got = P.arrival_schedule(_traffic(P, seed, 40, process=process,
                                          rate=rate))
        want = R.arrival_schedule(_traffic(R, seed, 40, process=process,
                                           rate=rate))
        assert [dataclasses.astuple(a) for a in got] == \
            [dataclasses.astuple(a) for a in want]
    full = P.arrival_schedule(_traffic(P, seed, 40, process=process))
    cut = P.arrival_schedule(dataclasses.replace(
        _traffic(P, seed, 40, process=process), horizon=full[9].time))
    assert cut == full[:10]


def test_retry_policy_equals_the_reference():
    for kw in ({}, {"max_attempts": 4, "backoff": 10.0, "multiplier": 2.0,
                    "cap": 25.0}):
        p, r = P.RetryPolicy(**kw), R.RetryPolicy(**kw)
        assert [p.delay(s, k) for s in (0, 7, 12345) for k in range(5)] == \
            [r.delay(s, k) for s in (0, 7, 12345) for k in range(5)]
    for bad in ({"max_attempts": 0}, {"multiplier": 0.5}, {"backoff": 0.0}):
        with pytest.raises(ValueError):
            P.RetryPolicy(**bad)
    with pytest.raises(ValueError, match="unknown arrival process"):
        P.TrafficConfig(tenants=(P.TenantSpec("t"),), process="nope")


def _pair(strategy, traffic_kw, n_nodes=16, churn=()):
    out = {}
    for name, pkg in (("port", P), ("ref", R)):
        extra = {"device": CPU} if pkg is P else {}
        sim = pkg.Simulation(None, pkg.SimConfig(n_nodes=n_nodes), strategy,
                             traffic=_traffic(pkg, **traffic_kw), **extra)
        for t, n in churn:
            sim.schedule_failure(t, n)
        res = sim.run()
        out[name] = (sim, res, sim.traffic_result())
    (ps, pr, pt), (rs, rr, rt) = out["port"], out["ref"]
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert dataclasses.asdict(pt) == dataclasses.asdict(rt)
    assert ps.action_log == rs.action_log
    return pr, pt


@pytest.mark.parametrize("backlog", [None, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_traffic_runs_equal_the_reference(strategy, backlog):
    res, tres = _pair(strategy, {"seed": 5, "n_arrivals": 10,
                                 "max_backlog": backlog})
    assert tres.admitted + tres.rejected == tres.arrivals == 10
    assert tres.completed > 0 and res.tasks_total > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_retrying_tenant_equals_the_reference(strategy):
    _, tres = _pair(strategy, {"seed": 2, "n_arrivals": 10, "rate": 0.5,
                               "max_backlog": 1,
                               "retry": {"max_attempts": 3,
                                         "backoff": 20.0}}, n_nodes=4)
    assert tres.retries > 0 and tres.churn["arrivals_sampled"] > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_traffic_with_a_node_failure_equals_the_reference(strategy):
    _, tres = _pair(strategy, {"seed": 11, "n_arrivals": 8,
                               "max_backlog": 4, "process": "diurnal"},
                    n_nodes=8, churn=((40.0, 2),))
    assert tres.completed > 0


def test_run_traffic_equals_the_reference():
    got = P.run_traffic(_traffic(P, 3, max_backlog=4), "wow", device=CPU,
                        n_nodes=16)
    want = R.run_traffic(_traffic(R, 3, max_backlog=4), "wow", n_nodes=16)
    assert [dataclasses.asdict(x) for x in got] == \
        [dataclasses.asdict(x) for x in want]


def _golden(sim, res, g):
    assert len(sim.action_log) == g["n_actions"]
    assert hashlib.sha256(
        repr(sim.action_log).encode()).hexdigest() == g["action_log_sha256"]
    assert repr(res.makespan) == g["makespan"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dfs_churn_goldens_hold_the_port(strategy):
    """tests/test_traffic.py::test_dfs_churn_bench_rows_action_identical."""
    sim = P.Simulation(PW.make_workflow("group", scale=0.25),
                       P.SimConfig(dfs="ceph", ceph_replication=2), strategy,
                       device=CPU)
    sim.schedule_failure(30.0, 1)
    res = sim.run()
    g = TRAFFIC_GOLDENS[f"dfs_churn:{strategy}"]
    _golden(sim, res, g)
    assert repr(res.network_bytes) == g["network_bytes"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sim_throughput_goldens_hold_the_port(strategy):
    """tests/test_traffic.py::test_sim_throughput_bench_rows_action_identical:
    group at 2.56 on 256 nodes."""
    sim = P.Simulation(PW.make_workflow("group", scale=2.56),
                       P.SimConfig(n_nodes=256, dfs="ceph",
                                   flow_fill="heap"), strategy, device=CPU)
    res = sim.run()
    g = TRAFFIC_GOLDENS[f"sim_throughput:{strategy}"]
    _golden(sim, res, g)
    assert res.sim_steps == g["sim_steps"]


@pytest.mark.parametrize("key", ["chain:wow:ceph", "group:orig:nfs",
                                 "group:cws:ceph"])
def test_disabled_traffic_keeps_the_churn_goldens(key):
    wf_name, strategy, dfs = key.split(":")
    off = P.TrafficConfig(tenants=(P.TenantSpec("t"),), enabled=False)
    sim = P.Simulation(PW.make_workflow(wf_name, scale={"group": 0.25,
                                                        "chain": 0.3}[wf_name]),
                       P.SimConfig(dfs=dfs), strategy, traffic=off,
                       device=CPU)
    res = sim.run()
    assert sim.traffic is None
    _golden(sim, res, CHURN_GOLDENS[key])
    assert repr(res.network_bytes) == CHURN_GOLDENS[key]["network_bytes"]


def _stream(pkg, seed):
    """tests/test_traffic.py::_random_stream for either package."""
    rng = random.Random(seed)
    tenants = tuple(pkg.TenantSpec(f"t{i}", weight=rng.choice([0.5, 1.0, 2.0]),
                                   slo=rng.choice([None, 50.0, 120.0]))
                    for i in range(3))
    cfg = pkg.TrafficConfig(tenants=tenants, window=25.0,
                            starvation_factor=3.0, seed=seed)
    inst = PT.InstanceRecord if pkg is P else RT.InstanceRecord
    records, rejections, depths = [], [], []
    for i in range(25):
        t0 = rng.uniform(0, 200)
        name = tenants[rng.randrange(3)].name
        depths.append((t0, rng.randrange(40), rng.randrange(5)))
        if rng.random() < 0.2:
            rejections.append((t0, name))
            continue
        rec = inst(id=i, tenant=name, workflow="chain", arrival_t=t0,
                   n_tasks=3, task_ids=frozenset((3 * i, 3 * i + 1)),
                   attempts=1 + rng.randrange(2))
        if rng.random() < 0.8:
            rec.completed_t = t0 + rng.uniform(1, 300)
            rec.cpu_seconds = rng.uniform(0, 50)
        records.append(rec)
    end = max([200.0] + [r.completed_t for r in records
                         if r.completed_t is not None])
    return cfg, records, rejections, depths, end


@pytest.mark.parametrize("seed", [0, 1, 2, 99])
def test_traffic_metrics_equal_the_reference(seed):
    got = P.compute_traffic_result(*_stream(P, seed)[:4],
                                   end_time=_stream(P, seed)[4],
                                   retries=[(1.0, "t0")], churn={"a": 1})
    want = R.compute_traffic_result(*_stream(R, seed)[:4],
                                    end_time=_stream(R, seed)[4],
                                    retries=[(1.0, "t0")], churn={"a": 1})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    rng = random.Random(seed)
    xs = [rng.uniform(0, 10) for _ in range(17)]
    assert (P.gini(xs), P.jain(xs), P.efficiency(100.0, 30.0, 4)) == \
        (R.gini(xs), R.jain(xs), R.efficiency(100.0, 30.0, 4))
    for q in (0, 50, 90, 99, 100):
        assert P.percentile(xs, q) == R.percentile(xs, q)
    assert P.percentile([], 50) is None and P.jain([]) == 1.0


def test_namespaced_and_validate_equal_the_reference():
    from repro_torch.bridge import workflow_to_plain
    p = PW.make_workflow("group", scale=0.25).namespaced(40, 70, "t/3:")
    r = RW.make_workflow("group", scale=0.25).namespaced(40, 70, "t/3:")
    p.validate()
    assert workflow_to_plain(p) == workflow_to_plain(r)
    assert [list(f.consumers) for f in p.files.values()] == \
        [list(f.consumers) for f in r.files.values()]
    t = next(t for t in p.tasks.values() if t.inputs)
    p.files[t.inputs[0]].consumers.discard(t.id)
    with pytest.raises(ValueError, match="consumer set"):
        p.validate()
