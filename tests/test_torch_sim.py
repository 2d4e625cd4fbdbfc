"""Whole simulations of the port (``repro_torch.sim``) against the JAX
package's ``repro.sim`` on the CPU: every registry workflow under orig,
cws and wow, on Ceph and NFS, with node failure and elastic join, on a
hierarchical topology with each oracle switch (``reference_flow``,
``reference_core``, ``flow_fill="scan"``) and with the dense fill forced.
Each pair of runs gets fresh workflows of one build; ``SimResult`` must be
equal field for field and ``action_log`` entry for entry.  The ML
pipelines run as the port builds them (their compute times are the H100
roofline's), fed to both simulators through ``bridge.workflow_to_plain``.
The churn goldens of tests/data/churn_goldens.json hold the port too.  A
wow run on the CPU goes through the port's scheduler core on CPU
tensors.  Every seed is fixed."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.sim as R  # noqa: E402
import repro.sim.network as RN  # noqa: E402
import repro.workloads as RW  # noqa: E402
import repro_torch.sim as P  # noqa: E402
import repro_torch.sim.network as PN  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch.bridge import workflow_to_plain  # noqa: E402
from repro_torch.core import ReferenceWowScheduler  # noqa: E402

CPU = "cpu"
STRATEGIES = ["orig", "cws", "wow"]
# small enough that the 48 runs of a package take about a second
SCALES = {"rnaseq": 0.05, "sarek": 0.03, "chipseq": 0.05, "rangeland": 0.02}
with open(os.path.join(os.path.dirname(__file__), "data",
                       "churn_goldens.json")) as _f:
    CHURN_GOLDENS = json.load(_f)["scenarios"]


def _ref_workflow(plain):
    """The reference's ``Workflow`` from the port's plain form.  Each set
    is filled in ascending order, as ``WorkflowBuilder`` fills it (tasks are
    numbered in creation order), so it iterates as a built workflow's does
    and the engine submits consumers in the same order."""
    tasks = {}
    for fields in plain["tasks"]:
        t = RC.TaskSpec(*fields)
        tasks[t.id] = t
    files = {}
    for fid, size, producer, consumers in plain["files"]:
        f = RC.FileSpec(fid, size, producer)
        for c in consumers:
            f.consumers.add(c)
        files[fid] = f
    edges = {}
    for a, succ in plain["edges"]:
        edges[a] = set()
        for b in succ:
            edges[a].add(b)
    return R.Workflow(plain["name"], tasks, files, edges)


def _pair(build, strategy, cfg_kw=None, churn=(), joins=()):
    """One run of each package: ``build(pkg)`` gives a fresh workflow, the
    config is ``SimConfig(**cfg_kw)`` of each package's own."""
    cfg_kw = dict(cfg_kw or {})
    out = {}
    for name, pkg in (("port", P), ("ref", R)):
        kw = dict(cfg_kw)
        if "topology" in kw:
            kw["topology"] = pkg.TopologySpec(**kw["topology"])
        extra = {"device": CPU} if pkg is P else {}
        sim = pkg.Simulation(build(pkg), pkg.SimConfig(**kw), strategy,
                             **extra)
        for t, n in churn:
            sim.schedule_failure(t, n)
        for t, n in joins:
            sim.schedule_join(t, n)
        out[name] = (sim, sim.run())
    (ps, pr), (rs, rr) = out["port"], out["ref"]
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert repr(pr.makespan) == repr(rr.makespan)
    assert ps.action_log == rs.action_log
    return ps, pr


def _registry(name, scale, seed=0):
    def build(pkg):
        mod = PW if pkg is P else RW
        return mod.make_workflow(name, scale=scale, seed=seed)
    return build


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", [n for n in RW.ALL_WORKFLOWS
                                  if n not in RW.MLPIPES])
def test_registry_workflow_runs_equal_the_reference(name, strategy):
    sim, res = _pair(_registry(name, SCALES.get(name, 0.2)), strategy)
    assert res.tasks_total == len(sim.wf.tasks) > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["rnaseq", "syn_montage", "chain",
                                  "group_multiple"])
def test_nfs_runs_equal_the_reference(name, strategy):
    _pair(_registry(name, SCALES.get(name, 0.2), seed=2), strategy,
          {"dfs": "nfs", "n_nodes": 6})


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", RW.MLPIPES)
def test_ml_pipelines_as_the_port_builds_them(name, strategy):
    port = PW.make_workflow(name, scale=0.5, seed=1)
    plain = workflow_to_plain(port)
    ref = _ref_workflow(plain)
    assert workflow_to_plain(ref) == plain
    assert [list(f.consumers) for f in ref.files.values()] == \
        [list(f.consumers) for f in port.files.values()]
    build = lambda pkg: (PW.make_workflow(name, scale=0.5, seed=1)  # noqa: E731
                         if pkg is P else _ref_workflow(plain))
    sim, res = _pair(build, strategy)
    assert res.tasks_total == len(plain["tasks"])


@pytest.mark.parametrize("dfs", ["ceph", "nfs"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_failure_and_join_equal_the_reference(strategy, dfs):
    """A node fails mid-run and two join: the running tasks are resubmitted,
    COPs aborted, the DFS's repairs and redirected reads (orig, cws) or
    WOW's producer re-runs priced as the reference prices them."""
    sim, res = _pair(_registry("group", 0.3), strategy, {"dfs": dfs},
                     churn=((30.0, 1),), joins=((45.0, 8), (60.0, 1)))
    if strategy != "wow" and dfs == "ceph":
        assert res.repairs_completed > 0 and res.degraded_reads > 0


def test_double_failure_with_lost_files_equals_the_reference():
    _, res = _pair(_registry("group", 0.25), "orig", {"dfs": "ceph"},
                   churn=((30.0, 1), (40.0, 2)))
    assert res.rereplication_bytes > 0


@pytest.mark.parametrize("key", sorted(CHURN_GOLDENS))
def test_churn_goldens_hold_the_port(key):
    """tests/test_dfs_churn.py::test_failure_free_runs_match_pre_churn_goldens
    on the port."""
    wf_name, strategy, dfs = key.split(":")
    wf = PW.make_workflow(wf_name, scale={"group": 0.25, "chain": 0.3}[wf_name])
    sim = P.Simulation(wf, P.SimConfig(dfs=dfs), strategy, device=CPU)
    res = sim.run()
    g = CHURN_GOLDENS[key]
    assert len(sim.action_log) == g["n_actions"]
    assert hashlib.sha256(
        repr(sim.action_log).encode()).hexdigest() == g["action_log_sha256"]
    assert repr(res.makespan) == g["makespan"]
    assert repr(res.network_bytes) == g["network_bytes"]
    assert res.degraded_reads == res.repairs_completed == 0


SPEC8 = dict(rack_size=2, racks_per_site=2, oversubscription=4.0)
ORACLES = {"heap": {}, "scan": {"flow_fill": "scan"},
           "reference_flow": {"reference_flow": True},
           "reference_core": {"reference_core": True}}


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("oracle", list(ORACLES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_topology_runs_equal_the_reference(strategy, oracle, churn):
    """tests/test_topology.py::_run_topo's runs, each oracle switch."""
    kw = {"topology": SPEC8, **ORACLES[oracle]}
    sim, res = _pair(_registry("group", 0.25), strategy, kw,
                     churn=((30.0, 1),) if churn else (),
                     joins=((45.0, 9),) if churn else ())
    assert set(res.tier_bytes) <= {"rack", "site", "wan"}
    if oracle == "reference_flow":
        assert isinstance(sim.fm, P.ReferenceFlowManager)
    elif oracle == "reference_core" and strategy == "wow":
        assert isinstance(sim.strategy.sched, ReferenceWowScheduler)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dense_fill_forced_in_a_whole_run(strategy, monkeypatch):
    """Every recompute of the port's run after the first hierarchy link
    takes the dense fill on CPU tensors; the reference keeps its own
    threshold (its dense fill is bit-identical to its heap fill)."""
    monkeypatch.setattr(PN, "_VEC_MIN_MEMBERS", 0)
    sim, res = _pair(_registry("group_multiple", 0.3), strategy,
                     {"topology": SPEC8}, churn=((30.0, 1),))
    assert 0 < sim.fm.dense_fills <= res.flow_recomputes
    assert sim.fm._caps_t.device.type == "cpu"


def test_dense_fill_at_its_own_threshold(monkeypatch):
    """orig on a 64-node site topology welds its flows past 512
    memberships, so the dense fill runs without any patch."""
    sim, res = _pair(_registry("group", 0.64), "orig",
                     {"n_nodes": 64, "topology": dict(rack_size=8,
                                                      racks_per_site=2,
                                                      oversubscription=8.0)})
    assert sim.fm.dense_fills > 0
    assert RN._VEC_MIN_MEMBERS == PN._VEC_MIN_MEMBERS == 512


def test_wow_state_lies_on_the_simulations_device():
    sim, _ = _pair(_registry("fork", 0.2), "wow", {"n_nodes": 4})
    sched = sim.strategy.sched
    assert sim.device == torch.device("cpu")
    assert sched._cap_array.free_mem.device.type == "cpu"
    assert sim.strategy.dps.matrix.pbytes.device.type == "cpu"


def test_config_is_the_references_but_two_defaults():
    p = {f.name: f.default for f in dataclasses.fields(P.SimConfig)}
    r = {f.name: f.default for f in dataclasses.fields(R.SimConfig)}
    assert set(p) == set(r)
    assert {k for k in p if p[k] != r[k]} == {"vectorized"}
    assert p["vectorized"] is True and r["vectorized"] is None


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = PW.make_workflow("fork", scale=0.1)
    for strategy in STRATEGIES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.Simulation(wf, P.SimConfig(), strategy)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.run_workflow(wf, "wow")
    tr = P.TrafficConfig(tenants=(P.TenantSpec("t"),), n_arrivals=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.run_traffic(tr, "orig")
    res = P.run_workflow(wf, "orig", device=CPU, n_nodes=3)
    assert res.n_nodes == 3 and res.tasks_total == len(wf.tasks)
