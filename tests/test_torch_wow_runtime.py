"""The WOW runtime in the port against the JAX package's on the CPU: the
adapters and their decline-requeue contract (``core/adapter.py``), the mock
resource manager (``runtime/mockrm.py``), the Kubernetes dry run
(``runtime/k8s_dryrun.py``), the DPS users ``WowPrefetchPlanner`` and
``ReplicaPlacer``, and the state bridge.

The mock RM's real-clock runs repeat only their counters; on the port's
virtual clock (``VirtualClockLoop``) a run is a function of its seed, so
the reference's ``MockResourceManager`` run on the same loop gives the
port's report and action stream exactly.  Every seed is fixed."""
from __future__ import annotations

import dataclasses
import json
import random

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime as RR  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro.data import WowPrefetchPlanner as RPlanner  # noqa: E402
from repro_torch.bridge import actions_to_plain, wow_specs_from_plain  # noqa: E402,E501
from repro_torch.data import WowPrefetchPlanner as PPlanner  # noqa: E402
from repro_torch.runtime.mockrm import run_on_virtual_clock  # noqa: E402

GiB = 1 << 30
CPU = "cpu"


def _dag(pkg, width=4, stages=3):
    """tests/test_runtime.py::_adapter_dag: a stages x width fan-in DAG,
    each stage-s task reading every stage-(s-1) output."""
    tasks, files, prev = {}, {}, []
    tid = fid = 0
    for s in range(stages):
        new = []
        for w in range(width):
            files[fid] = pkg.FileSpec(id=fid, size=1 << 20, producer=tid)
            tasks[tid] = pkg.TaskSpec(id=tid, abstract=f"s{s}w{w}",
                                      mem=2 * GiB, cores=1.0,
                                      inputs=tuple(prev), outputs=(fid,),
                                      priority=1.0 + w)
            new.append(fid)
            tid += 1
            fid += 1
        prev = new
    return tasks, files


def _nodes(pkg, n=3):
    return {i: pkg.NodeState(i, 16 * GiB, 8.0) for i in range(n)}


def _adapter(pkg, name, nodes, **kw):
    if pkg is P:
        kw["device"] = CPU
    return pkg.make_adapter(name, nodes, **kw)


# ------------------------------------------------------------- conformance
def test_adapters_implement_protocol():
    assert P.ADAPTER_API == R.ADAPTER_API
    for name in ("orig", "cws", "wow"):
        P.assert_implements(_adapter(P, name, _nodes(P)))
    P.assert_implements(P.WowScheduler(
        _nodes(P), P.DataPlacementService(seed=0), device=CPU))

    class Half:
        def submit(self, task):
            pass

    with pytest.raises(TypeError, match="decline"):
        P.assert_implements(Half())
    with pytest.raises(ValueError, match="unknown strategy"):
        _adapter(P, "nope", _nodes(P))


def _build_wow(pkg, free_state, reg_log, queued, specs, seed):
    """tests/test_adapter.py::_build_wow: a scheduler built fresh from the
    visible state."""
    nodes = {n: pkg.NodeState(n, 16 * GiB, 8.0, free_mem=fm, free_cores=fc)
             for n, (fm, fc) in free_state.items()}
    dev = {"device": CPU} if pkg is P else {}
    dps = pkg.DataPlacementService(seed=seed)
    for fid, size, locs in reg_log:
        dps.register_file(pkg.FileSpec(id=fid, size=size, producer=-1),
                          locs[0])
        for n in locs[1:]:
            dps.add_replica(fid, n)
    sched = pkg.WowScheduler(nodes, dps, c_node=0, **dev)
    for tid in queued:
        sched.submit(pkg.TaskSpec(**specs[tid]))
    return sched


@pytest.mark.parametrize("name", ["orig", "cws", "wow"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decline_stream_equal(seed, name):
    """tests/test_adapter.py:164's stream of submits, declines and
    out-of-order completions: the port's adapter makes the reference
    adapter's decisions, and each equals a port scheduler built fresh from
    the visible state (the decline-requeue contract)."""
    rng = random.Random(seed)
    ads = {pkg: _adapter(pkg, name, _nodes(pkg, 4), c_node=0, seed=7)
           for pkg in (R, P)}
    specs: dict[int, dict] = {}
    reg_log: list = []
    queued: list[int] = []
    running: dict[int, int] = {}
    next_tid = 0

    def free(pkg):
        return {n: (s.free_mem, s.free_cores)
                for n, s in ads[pkg].nodes.items()}

    def check_and_apply():
        if name == "wow":
            oracle = _build_wow(P, free(P), reg_log, queued, specs, seed=7)
            expect = actions_to_plain(oracle.schedule())
        else:
            expect = None
        got = {pkg: [a for a in ads[pkg].schedule()
                     if not hasattr(a, "plan")] for pkg in (R, P)}
        assert actions_to_plain(got[P]) == actions_to_plain(got[R])
        if expect is not None:
            assert actions_to_plain(got[P]) == expect
        decline = [rng.random() < 0.4 for _ in got[R]]
        for pkg in (R, P):
            for a, no in zip(got[pkg], decline):
                ads[pkg].task_started(a.task_id, a.node)
                if no:
                    ads[pkg].decline(a.task_id, a.node, "rm_throttled")
        for a, no in zip(got[R], decline):
            queued.remove(a.task_id)
            if no:
                queued.append(a.task_id)
            else:
                running[a.task_id] = a.node

    for _ in range(14):
        op = rng.random()
        if op < 0.45:
            tid, next_tid = next_tid, next_tid + 1
            inputs = ()
            if name == "wow" and rng.random() < 0.7:
                locs = sorted(rng.sample(range(4), rng.randint(1, 3)))
                for pkg in (R, P):
                    ads[pkg].dps.register_file(
                        pkg.FileSpec(id=tid, size=1 << 20, producer=-1),
                        locs[0])
                    for n in locs[1:]:
                        ads[pkg].dps.add_replica(tid, n)
                reg_log.append((tid, 1 << 20, locs))
                inputs = (tid,)
            specs[tid] = dict(id=tid, abstract=f"t{tid}",
                              mem=rng.randint(1, 4) * GiB,
                              cores=float(rng.randint(1, 4)), inputs=inputs,
                              priority=round(rng.uniform(1, 10), 3))
            for pkg in (R, P):
                ads[pkg].submit(pkg.TaskSpec(**specs[tid]))
            queued.append(tid)
        elif op < 0.75:
            check_and_apply()
        elif running:
            tid = rng.choice(sorted(running))
            node = running.pop(tid)
            for pkg in (R, P):
                ads[pkg].task_finished(tid, node)
    check_and_apply()
    assert ads[P].declines == ads[R].declines
    assert free(P) == free(R)
    # unknown ids are no-ops
    for pkg in (R, P):
        ads[pkg].decline(10 ** 6, 0)
        ads[pkg].task_finished(10 ** 6, 0)
        ads[pkg].forget_task(10 ** 6)
    assert free(P) == free(R)


# ------------------------------------------------------------- mock RM
class _Recorder:
    """An adapter seen through a log of its schedule() actions (neither
    package's mock RM keeps one)."""

    def __init__(self, adapter):
        self._ad = adapter
        self.actions = []

    def schedule(self):
        acts = self._ad.schedule()
        self.actions.extend(acts)
        return acts

    def __getattr__(self, name):
        return getattr(self._ad, name)


RM_CASES = [
    ("orig", dict(latency_s=0.001, decline_prob=0.3, external_load=0.3,
                  seed=3)),
    ("cws", dict(latency_s=0.001, decline_prob=0.3, external_load=0.3,
                 seed=3)),
    ("wow", dict(latency_s=0.001, decline_prob=0.3, external_load=0.3,
                 seed=3)),
    ("wow", dict(latency_s=0.0005, decline_prob=0.4, external_load=0.4,
                 seed=5)),
    ("cws", dict(latency_s=0.0005, decline_prob=1.0, max_attempts=3,
                 seed=0)),
    ("wow", dict(latency_s=0.0005, seed=1)),
]


@pytest.mark.parametrize("name,cfg", RM_CASES)
def test_mock_rm_on_virtual_clock_equal(name, cfg):
    """The port's ``run_mock_rm`` on the virtual clock against the
    reference's ``MockResourceManager`` on the same loop: the report field
    for field (its wall time in virtual seconds too), the action stream
    element for element, and for wow the DPS's replicas."""
    rtasks, rfiles = _dag(R)
    rad = _Recorder(_adapter(R, name, _nodes(R), seed=cfg["seed"]))
    rrm = RR.MockResourceManager(rad, rtasks, rfiles, RR.MockRMConfig(**cfg))
    want = run_on_virtual_clock(rrm.run())
    ptasks, pfiles = _dag(P)
    pad = _Recorder(_adapter(P, name, _nodes(P), seed=cfg["seed"]))
    prm = PR.MockResourceManager(pad, ptasks, pfiles, PR.MockRMConfig(**cfg))
    got = run_on_virtual_clock(prm.run())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert actions_to_plain(pad.actions) == actions_to_plain(rad.actions)
    assert got.completed == len(ptasks) and got.wall_s > 0
    if cfg.get("decline_prob"):
        assert got.declines > 0
    if name == "wow":
        for fid in pfiles:
            assert pad.dps.locations(fid) == rad.dps.locations(fid)


@pytest.mark.parametrize("name", ["cws", "wow"])
def test_mock_rm_real_clock_counters_equal(name):
    """On the real clock, as the reference's own test holds it: the wire
    counters keyed by (seed, task, attempt) repeat."""
    cfg = dict(latency_s=0.0005, decline_prob=0.4, external_load=0.4, seed=5)
    want = RR.run_mock_rm(_adapter(R, name, _nodes(R), seed=5), *_dag(R),
                          RR.MockRMConfig(**cfg))
    got = PR.run_mock_rm(_adapter(P, name, _nodes(P), seed=5), *_dag(P),
                         PR.MockRMConfig(**cfg), device=CPU)
    assert (got.completed, got.declines, got.capacity_declines) == \
        (want.completed, want.declines, want.capacity_declines)


def test_mock_rm_device(monkeypatch):
    ad = _adapter(P, "wow", _nodes(P))
    with pytest.raises(ValueError, match="state on cpu"):
        PR.run_mock_rm(ad, *_dag(P), device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PR.run_mock_rm(ad, *_dag(P))


def test_virtual_clock_orders_timers_by_deadline():
    import asyncio
    seen = []

    async def sleeper(tag, d):
        await asyncio.sleep(d)
        seen.append((tag, asyncio.get_running_loop().time()))

    async def main():
        await asyncio.gather(sleeper("b", 0.2), sleeper("a", 0.1),
                             sleeper("c", 3600.0))
    run_on_virtual_clock(main())
    assert [t for t, _ in seen] == ["a", "b", "c"]
    assert seen[-1][1] >= 3600.0


# ------------------------------------------------------------- k8s dry-run
def test_manifests_equal():
    rt = R.TaskSpec(id=7, abstract="BWA_Index", mem=3 << 30, cores=1.5,
                    inputs=(), priority=2.0)
    pt = P.TaskSpec(id=7, abstract="BWA_Index", mem=3 << 30, cores=1.5,
                    inputs=(), priority=2.0)
    assert PR.pod_manifest(pt, 3) == RR.pod_manifest(rt, 3)
    assert PR.pod_manifest(pt, 3, namespace="x", image="i") == \
        RR.pod_manifest(rt, 3, namespace="x", image="i")
    rp = R.CopPlan(id=11, task_id=4, target=2, transfers=[
        R.Transfer(file_id=9, size=1 << 20, src=0, dst=2)], price=1.0)
    pp = P.CopPlan(id=11, task_id=4, target=2, transfers=[
        P.Transfer(file_id=9, size=1 << 20, src=0, dst=2)], price=1.0)
    assert PR.cop_job_manifest(pp) == RR.cop_job_manifest(rp)


@pytest.mark.parametrize("c_node", [0, 1])
def test_k8s_dry_run_equal(c_node):
    """tests/test_runtime.py:199-243's dry run, stepped through a fan-in
    DAG's first stages: the manifests and their JSON are the reference's."""
    dry = {}
    for pkg, rt in ((R, RR), (P, PR)):
        # node 1 holds every input but has one core: one pod starts there,
        # and with a COP slot the others get copy jobs
        nodes = {i: pkg.NodeState(i, 16 * GiB, 1.0 if i == 1 else 8.0)
                 for i in range(3)}
        ad = _adapter(pkg, "wow", nodes, c_node=c_node)
        tasks, files = _dag(pkg, width=3, stages=2)
        for f in range(3):
            ad.dps.register_file(files[f], 1)
            ad.dps.add_replica(f, (f + 1) % 3)
        for t in range(3, 6):
            ad.submit(tasks[t])
        dry[pkg] = rt.K8sDryRun(ad, namespace="wow-test")
        dry[pkg].step()
        dry[pkg].step()
    assert dry[P].manifests == dry[R].manifests
    assert dry[P].to_json() == dry[R].to_json()
    kinds = [m["kind"] for m in json.loads(dry[P].to_json())]
    assert kinds.count("Pod") == 1
    assert ("Job" in kinds) == (c_node > 0)
    with pytest.raises(KeyError, match="specs="):
        PR.K8sDryRun(P.WowScheduler(
            _nodes(P), P.DataPlacementService(seed=0),
            device=CPU), specs={})._spec_of(0)


# ----------------------------------------------------------- DPS users
def test_replica_placer_equal():
    """tests/test_runtime.py:102-115: placements, loads and survivors."""
    for n_hosts, reps, sizes in [(8, 2, [100] * 32), (4, 2, [100] * 20),
                                 (5, 3, [random.Random(1).randint(1, 999)
                                         for _ in range(17)])]:
        rp = RR.ReplicaPlacer(n_hosts=n_hosts, replicas=reps)
        pp = PR.ReplicaPlacer(n_hosts=n_hosts, replicas=reps)
        assert pp.place(sizes) == rp.place(sizes)
        assert pp.load == rp.load
        for lost in ({3}, {0, 1}, {0}, set(range(n_hosts))):
            assert pp.survivors(lost) == rp.survivors(lost)
        assert pp.dps._locations == rp.dps._locations


def test_prefetch_planner_equal():
    """tests/test_runtime.py:122-132: the planned fetches step by step, the
    re-plans that fetch nothing, and a lost host's recovery."""
    rp = RPlanner(n_hosts=4, shard_bytes=1000, lookahead=2)
    pp = PPlanner(n_hosts=4, shard_bytes=1000, lookahead=2)
    for step in (0, 0, 1, 3, 1):
        assert pp.plan_step(step) == rp.plan_step(step)
    for host in (1, 2, 1):
        assert pp.recover_host(host) == rp.recover_host(host)
    assert pp.dps._locations == rp.dps._locations


def test_dps_users_need_no_card(monkeypatch):
    """Placement and prefetch planning are host work: the DPS keeps its
    COP matrix only for a scheduler that asks for one, so the users run
    where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = PR.ReplicaPlacer(n_hosts=2)
    assert pp.place([10, 20]) == RR.ReplicaPlacer(n_hosts=2).place([10, 20])
    assert pp.dps.matrix is None
    planner = PPlanner(n_hosts=2, shard_bytes=1)
    assert planner.plan_step(0) == RPlanner(n_hosts=2,
                                            shard_bytes=1).plan_step(0)
    assert planner.dps.matrix is None


# ------------------------------------------------------------------ bridge
def test_bridge_carries_state_both_forms():
    rnodes = [R.NodeState(2, 4 * GiB, 2.0, free_mem=GiB), R.NodeState(0, 1, 1)]
    rtask = R.TaskSpec(id=5, abstract="a", mem=1, cores=0.5, inputs=(1, 1),
                       outputs=(3,), priority=2.0, rank=1)
    rfile = R.FileSpec(id=1, size=10, producer=4, consumers={5, 6})
    for form in (dataclasses.astuple, dataclasses.asdict):
        got = wow_specs_from_plain(nodes=[form(n) for n in rnodes],
                                   tasks=[form(rtask)], files=[form(rfile)],
                                   replicas={1: [2, 0]})
        assert list(got["nodes"]) == [2, 0]
        assert [dataclasses.astuple(n) for n in got["nodes"].values()] == \
            [dataclasses.astuple(n) for n in rnodes]
        assert dataclasses.astuple(got["tasks"][5]) == \
            dataclasses.astuple(rtask)
        assert got["files"][1].consumers == {5, 6}
        assert got["replicas"] == {1: (2, 0)}
        assert isinstance(got["tasks"][5], P.TaskSpec)
    plan = P.CopPlan(id=3, task_id=5, target=2, transfers=[
        P.Transfer(1, 10, 0, 2)], price=7.5)
    assert actions_to_plain([P.StartTask(5, 2), P.StartCop(plan)]) == [
        ("task", 5, 2), ("cop", 3, 5, 2, ((1, 10, 0, 2),), 7.5, 10)]
