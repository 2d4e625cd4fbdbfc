"""The WOW core's building blocks in the port (``repro_torch/core``, its
topology) against the JAX package's ``repro/core`` on the CPU: priorities,
the step-1 solver in every tier, the DPS's indices and COP-plan stream, the
COP matrix, the hot node state and the topology.

Every case is drawn from a fixed seed (no hypothesis draws): both packages
get the same plain state through ``repro_torch/bridge.py`` and must give
the same answers, element for element.  The greedy solver's cases include
seeds 26663, 38955 and 77777, where it reaches less than half the optimum
(``ROADMAP.md`` §3): the port holds the reference's greedy answer there,
and no test asserts an approximation ratio."""
from __future__ import annotations

import dataclasses
import random

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.ilp as R_ilp  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.core.ilp as P_ilp  # noqa: E402
from repro.sim import Topology as RTopology  # noqa: E402
from repro.sim import TopologySpec as RSpec  # noqa: E402
from repro_torch.bridge import actions_to_plain, wow_specs_from_plain  # noqa: E402,E501
from repro_torch.sim import Topology as PTopology  # noqa: E402
from repro_torch.sim import TopologySpec as PSpec  # noqa: E402

GiB = 1024 ** 3
MB = 1024 ** 2
CPU = "cpu"


def _plain(objs):
    return [dataclasses.astuple(o) for o in objs]


def _port(nodes=(), tasks=()):
    """The port's copies of reference NodeStates and TaskSpecs."""
    got = wow_specs_from_plain(nodes=_plain(nodes), tasks=_plain(tasks))
    return got["nodes"], got["tasks"]


# ------------------------------------------------------------- priorities
def test_priorities_equal():
    edges = {"s": {"a", "b"}, "a": {"t"}, "b": {"x"}, "x": {"t"},
             "t": set(), "lone": set()}
    assert P.abstract_ranks(edges) == R.abstract_ranks(edges)
    with pytest.raises(ValueError):
        P.abstract_ranks({"a": {"b"}, "b": {"a"}})
    for rank, size in [(0, 0), (1, 10 ** 9), (3, 2 ** 50), (2, 2 ** 60)]:
        assert P.priority_value(rank, size) == R.priority_value(rank, size)
    rng = random.Random(3)
    sizes = {f: rng.randint(1, 10 ** 9) for f in range(6)}
    ref = [R.TaskSpec(id=i, abstract=rng.choice("stabx"), mem=1, cores=1.0,
                      inputs=tuple(rng.sample(range(6), 2)),
                      dfs_inputs=rng.randint(0, 99)) for i in range(8)]
    _, port = _port(tasks=ref)
    ranks = R.abstract_ranks(edges)
    R.assign_priorities(ref, ranks, sizes)
    P.assign_priorities(list(port.values()), ranks, sizes)
    assert [(t.rank, t.priority) for t in ref] == \
        [(t.rank, t.priority) for t in port.values()]


# -------------------------------------------------------------------- ILP
def _mk_problem(rng, n_tasks, n_nodes):
    """tests/test_core_scheduler.py::_mk_problem, drawn once for both."""
    nodes = {i: R.NodeState(i, mem=rng.randint(4, 16) * GiB,
                            cores=rng.randint(2, 16)) for i in range(n_nodes)}
    tasks, prepared = [], {}
    for t in range(n_tasks):
        tasks.append(R.TaskSpec(id=t, abstract="a",
                                mem=rng.randint(1, 8) * GiB,
                                cores=rng.randint(1, 8),
                                priority=rng.uniform(0.1, 10.0)))
        prepared[t] = rng.sample(range(n_nodes), rng.randint(0, n_nodes))
    pnodes, ptasks = _port(nodes.values(), tasks)
    return (R.AssignmentProblem(tasks, prepared, nodes),
            P.AssignmentProblem(list(ptasks.values()),
                                {k: list(v) for k, v in prepared.items()},
                                pnodes))


# seeds, tasks, nodes; (6, 3) is test_greedy_not_catastrophic's size
ILP_CASES = ([(s, 6, 3) for s in (26663, 38955, 77777, 0, 1, 2)]
             + [(s, 7, 4) for s in range(3, 9)]
             + [(s, 14, 5) for s in range(9, 13)]
             + [(s, 30, 6) for s in range(13, 16)])


@pytest.mark.parametrize("seed,n_tasks,n_nodes", ILP_CASES)
def test_ilp_tiers_equal(seed, n_tasks, n_nodes):
    """solve_exact, solve_greedy, solve (decomposed), solve_monolithic and
    decompose give the reference's assignments and components."""
    ref, port = _mk_problem(random.Random(seed), n_tasks, n_nodes)
    assert P.solve_exact(port) == R.solve_exact(ref)
    assert P.solve_greedy(port) == R.solve_greedy(ref)
    assert P.solve(port) == R.solve(ref)
    assert P.solve_monolithic(port) == R.solve_monolithic(ref)
    assert P.solve_exact(port, node_budget=50) == \
        R.solve_exact(ref, node_budget=50)
    assert [(sorted(p.prepared.items()), sorted(p.nodes))
            for p in P.decompose(port)] == \
        [(sorted(p.prepared.items()), sorted(p.nodes))
         for p in R.decompose(ref)]


def test_greedy_below_half_the_optimum_is_the_reference_answer():
    """At the three seeds where greedy reaches less than half the optimum,
    the port's greedy is the reference's greedy (objective and placement),
    and its exact tier the reference's optimum."""
    seen = {}
    for seed in (26663, 38955, 77777):
        ref, port = _mk_problem(random.Random(seed), 6, 3)
        g = P.solve_greedy(port)
        assert g == R.solve_greedy(ref)
        assert P_ilp.objective(port, g) == R_ilp.objective(
            ref, R.solve_greedy(ref))
        assert P_ilp.objective(port, P.solve_exact(port)) == \
            R_ilp.objective(ref, R.solve_exact(ref))
        seen[seed] = round(P_ilp.objective(port, g), 3)
    assert seen == {26663: 13.003, 38955: 12.757, 77777: 12.025}


@pytest.mark.parametrize("seed", range(4))
def test_ilp_with_capacity_array_equal(seed):
    """Long candidate lists take the capacity tensors' gathers
    (``_free_maps``, ``filter_fitting``, the fingerprint): same answers as
    the reference's numpy arrays."""
    rng = random.Random(100 + seed)
    nodes = {i: R.NodeState(i, mem=rng.randint(4, 16) * GiB,
                            cores=float(rng.randint(2, 16)),
                            free_mem=rng.randint(0, 16) * GiB,
                            free_cores=float(rng.randint(0, 16)))
             for i in range(24)}
    tasks = [R.TaskSpec(id=t, abstract="a", mem=rng.randint(1, 6) * GiB,
                        cores=float(rng.randint(1, 6)),
                        priority=rng.uniform(0.1, 10.0)) for t in range(30)]
    prepared = {t: rng.sample(range(24), rng.randint(16, 24))
                for t in range(30)}
    pnodes, ptasks = _port(nodes.values(), tasks)
    rcap = R.NodeCapacityArray(nodes, list(nodes), 1)
    pcap = P.NodeCapacityArray(pnodes, list(pnodes), 1, device=CPU)
    ref = R.AssignmentProblem(tasks, prepared, nodes, rcap)
    port = P.AssignmentProblem(list(ptasks.values()),
                               {k: list(v) for k, v in prepared.items()},
                               pnodes, pcap)
    for solver in ("solve_greedy", "solve", "solve_monolithic"):
        assert getattr(P, solver)(port) == getattr(R, solver)(ref), solver
    tids = [t.id for t in tasks]
    assert P.component_fingerprint(tids, ptasks, port.prepared, pnodes,
                                   cap=pcap) == \
        R.component_fingerprint(tids, {t.id: t for t in tasks}, prepared,
                                nodes, cap=rcap)


@pytest.mark.parametrize("strict", [True, False])
def test_incremental_solver_event_stream_equal(strict):
    """IncrementalAssignmentSolver over a stream of dirty-set events: every
    event's assignment and the final counters are the reference's (the
    cache, the component reuse and, unstrict, the warm seeds included)."""
    rng = random.Random(7)
    n_nodes = 10
    rnodes = {i: R.NodeState(i, 16 * GiB, 8.0) for i in range(n_nodes)}
    pnodes, _ = _port(rnodes.values())
    rs = R.IncrementalAssignmentSolver(rnodes, strict_parity=strict)
    ps = P.IncrementalAssignmentSolver(pnodes, strict_parity=strict)
    rtasks, ptasks, cands, seq = {}, {}, {}, {}
    carried_t, carried_n = set(), set()
    for step in range(60):
        dirty_t, dirty_n = carried_t, carried_n
        for _ in range(rng.randint(0, 3)):               # new ready tasks
            tid = len(seq)
            t = R.TaskSpec(id=tid, abstract="a", mem=rng.randint(1, 6) * GiB,
                           cores=float(rng.randint(1, 4)),
                           priority=round(rng.uniform(1, 9), 2))
            rtasks[tid] = t
            ptasks[tid] = _port(tasks=[t])[1][tid]
            seq[tid] = tid
            cands[tid] = sorted(rng.sample(range(n_nodes), rng.randint(1, 3)))
            dirty_t.add(tid)
        for _ in range(rng.randint(0, 2)):               # capacity changes
            n = rng.randrange(n_nodes)
            fm, fc = rng.randint(0, 16) * GiB, float(rng.randint(0, 8))
            for nodes in (rnodes, pnodes):
                nodes[n].free_mem, nodes[n].free_cores = fm, fc
            dirty_n.add(n)
        live = {t: c for t, c in cands.items() if t in rtasks}
        got = ps.solve_event(ptasks, live, seq, set(dirty_t), set(dirty_n))
        want = rs.solve_event(rtasks, live, seq, set(dirty_t), set(dirty_n))
        assert got == want, step
        # an applied assignment dirties its node; a declined one its task
        carried_t, carried_n = set(), set()
        for tid, n in want.items():
            if rng.random() < 0.7:                       # started
                t = rtasks.pop(tid)
                del ptasks[tid]
                for nodes in (rnodes, pnodes):
                    nodes[n].free_mem -= t.mem
                    nodes[n].free_cores -= t.cores
                carried_n.add(n)
            else:
                carried_t.add(tid)
    assert rs.stats["events"] == 60 and rs.stats["exact_solves"] > 0
    drop = {"solve_s"}
    assert {k: v for k, v in ps.stats.items() if k not in drop} == \
        {k: v for k, v in rs.stats.items() if k not in drop}


# -------------------------------------------------------------------- DPS
def _dps_pair(seed, topo=None, n_nodes=8):
    rd = R.DataPlacementService(seed=seed)
    pd = P.DataPlacementService(seed=seed)
    if topo is not None:
        rd.set_topology(RTopology(RSpec(**topo), n_nodes, 100.0))
        pd.set_topology(PTopology(PSpec(**topo), n_nodes, 100.0))
    return rd, pd


class _Plans(list):
    """A COP probe's answer, as actions, told apart from other lists."""


_INDICES = ("_locations", "_node_files", "_waiting", "_task_inputs",
            "_task_mult", "_task_bytes", "_present_cnt", "_present_bytes",
            "_prep", "_node_prep_tasks", "_dirty_tasks", "_free_src",
            "_free_rep", "_unsourced", "_blocked_dirty", "_next_cop_id",
            "cop_bytes_total")


def _same_dps(rd, pd):
    for name in _INDICES:
        assert getattr(pd, name) == getattr(rd, name), name
    assert pd._rng.getstate() == rd._rng.getstate()


@pytest.mark.parametrize("seed,topo", [
    (0, None), (1, None), (2, None), (3, None),
    (4, {"rack_size": 2, "racks_per_site": 2}),
    (5, {"rack_size": 3, "racks_per_site": 0}),
    (6, {"rack_size": 2, "racks_per_site": 2, "w_site": 3}),
])
def test_dps_stream_equal(seed, topo):
    """tests/test_copmatrix.py:43's random mutation stream with COP plans,
    commits and the source-feasibility index: after every event every DPS
    index and the tie-break generator's state are the reference's, each COP
    plan is the reference's plan, the port's matrix mirrors its dicts
    cell for cell and a rebuild equals it."""
    rng = random.Random(seed)
    rd, pd = _dps_pair(seed, topo)
    mx = pd.enable_matrix(CPU)
    assert mx.cnt.dtype == torch.int32 and mx.pbytes.dtype == torch.int64
    nodes = list(range(8))
    for d in (rd, pd):
        d.sync_free_sources(nodes[:5])
    files: list[int] = []
    tracked: dict[int, tuple] = {}
    plans = []
    next_f = next_t = 0
    for _ in range(150):
        op = rng.randrange(11)
        calls = []
        if op == 0 or not files:
            fid, next_f = next_f, next_f + 1
            size, node = rng.randrange(1, 64) * MB, rng.choice(nodes)
            calls.append(lambda d, pkg: d.register_file(
                pkg.FileSpec(fid, size, 0), node))
            files.append(fid)
        elif op == 1:
            fid, node = rng.choice(files), rng.choice(nodes)
            calls.append(lambda d, pkg: d.add_replica(fid, node))
        elif op == 2:
            fid = rng.choice(files)
            locs = sorted(rd.locations(fid))
            if locs:
                node = rng.choice(locs)
                calls.append(lambda d, pkg: d.remove_replica(fid, node))
        elif op == 3 or not tracked:
            tid, next_t = next_t, next_t + 1
            inputs = tuple(rng.choice(files) for _ in range(rng.randrange(1, 5)))
            tracked[tid] = inputs
            calls.append(lambda d, pkg: d.track_task(tid, inputs))
        elif op == 4:
            tid = rng.choice(sorted(tracked))
            del tracked[tid]
            calls.append(lambda d, pkg: d.untrack_task(tid))
        elif op == 5:
            node = rng.choice(nodes)
            calls.append(lambda d, pkg: d.drop_node(node))
        elif op == 6:
            fid = rng.choice(files)
            locs = sorted(rd.locations(fid))
            if locs:
                calls.append(lambda d, pkg: d.invalidate(fid, locs[0]))
        elif op == 7:
            fid = rng.choice(files)
            calls.append(lambda d, pkg: d.delete_replicas(fid, keep=1))
        elif op == 8:
            node = rng.choice(nodes)
            fn = rng.choice(["note_source_freed", "note_source_busy"])
            calls.append(lambda d, pkg: getattr(d, fn)(node))
        else:                                    # plan (and commit) a COP
            tid = rng.choice(sorted(tracked))
            node = rng.choice(nodes)
            allowed = set(rng.sample(nodes, 5)) if op == 9 else None
            commit = rng.random() < 0.7

            def cop(d, pkg, tid=tid, node=node, allowed=allowed,
                    commit=commit):
                plan = d.plan_cop(tid, tracked[tid], node, allowed)
                if plan is not None and commit:
                    d.commit_cop(plan)
                return _Plans([] if plan is None else [pkg.StartCop(plan)])
            calls.append(cop)
        for call in calls:
            got, want = call(pd, P), call(rd, R)
            if isinstance(want, _Plans):
                plans.append(actions_to_plain(want))
                assert actions_to_plain(got) == plans[-1]
            else:
                assert got == want
        _same_dps(rd, pd)
        for tid in tracked:
            assert pd.cop_blocked(tid) == rd.cop_blocked(tid)
            assert pd.prepared_nodes_task(tid) == rd.prepared_nodes_task(tid)
            for n in nodes:
                assert pd.locality_missing_cost(tid, n) == \
                    rd.locality_missing_cost(tid, n)
        mx.check_against(pd)
    assert any(plans), "no COP was planned"
    snap = {tid: mx.snapshot(tid) for tid in mx._row_of}
    mx.rebuild(pd)
    mx.check_against(pd)
    assert snap == {tid: mx.snapshot(tid) for tid in mx._row_of}
    assert pd.drain_dirty_tasks() == rd.drain_dirty_tasks()
    assert pd.drain_blocked_dirty() == rd.drain_blocked_dirty()


@pytest.mark.parametrize("seed", range(6))
def test_dps_reference_queries_equal(seed):
    """tests/test_incremental.py:41's stream: the indexed queries, the
    from-scratch reference queries and the dropped-node answers."""
    rng = random.Random(seed)
    n_nodes, n_files = rng.randint(2, 6), rng.randint(2, 10)
    nodes = list(range(n_nodes))
    rd, pd = _dps_pair(seed)
    for f in range(n_files):
        size, node = rng.randint(1, 1000), rng.randrange(n_nodes)
        rd.register_file(R.FileSpec(id=f, size=size, producer=-1), node)
        pd.register_file(P.FileSpec(id=f, size=size, producer=-1), node)
    tracked = {}
    for tid in range(rng.randint(1, 5)):
        tracked[tid] = tuple(rng.sample(range(n_files),
                                        rng.randint(1, min(4, n_files))))
        rd.track_task(tid, tracked[tid])
        pd.track_task(tid, tracked[tid])
    for _ in range(80):
        op, fid, node = rng.randrange(6), rng.randrange(n_files), \
            rng.randrange(n_nodes)
        if op == 0:
            for d in (rd, pd):
                d.add_replica(fid, node)
        elif op == 1:
            assert pd.drop_node(node) == rd.drop_node(node)
        elif op == 2:
            keep = rng.randint(0, 2)
            assert pd.delete_replicas(fid, keep=keep) == \
                rd.delete_replicas(fid, keep=keep)
        elif op == 3:
            for d in (rd, pd):
                d.invalidate(fid, only_valid=node)
        elif tracked:
            tid = rng.choice(sorted(tracked))
            got = pd.plan_cop(tid, tracked[tid], target=node)
            want = rd.plan_cop(tid, tracked[tid], target=node)
            assert actions_to_plain([P.StartCop(got)] if got else []) == \
                actions_to_plain([R.StartCop(want)] if want else [])
            if want is not None:
                rd.commit_cop(want)
                pd.commit_cop(got)
        for tid, inputs in tracked.items():
            for n in nodes:
                assert pd.missing_bytes_task(tid, n) == \
                    rd.missing_bytes_reference(inputs, n)
                assert pd.is_prepared_reference(inputs, n) == \
                    rd.is_prepared_task(tid, n)
            assert pd.prepared_nodes(inputs, nodes) == \
                rd.prepared_nodes(inputs, nodes)
            assert pd.cop_feasible_targets(inputs, set(nodes[:2])) == \
                rd.cop_feasible_targets(inputs, set(nodes[:2]))
        assert pd.total_replica_bytes() == rd.total_replica_bytes()
        assert pd.unique_bytes() == rd.unique_bytes()


def test_dps_matrix_on_the_asked_device():
    """The DPS keeps no tensor until a scheduler enables its COP matrix on
    the scheduler's device; the DPS has one matrix, so another device is
    refused, and the same one (by another name) rebuilds it."""
    pd = P.DataPlacementService(seed=0)
    assert pd.matrix is None
    mx = pd.enable_matrix(CPU)
    assert mx.cnt.device.type == "cpu" and pd.matrix is mx
    assert pd.enable_matrix(torch.device("cpu")) is mx
    with pytest.raises(ValueError, match="COP matrix on cpu"):
        pd.enable_matrix("meta")


def test_matrix_null_column_and_recycling():
    """tests/test_copmatrix.py's unit surface on the tensors: the null
    column reads 0 like ``dict.get(node, 0)``, a dropped node's column is
    recycled, and rows and columns grow past their first allocation."""
    pd = P.DataPlacementService(seed=0)
    mx = pd.enable_matrix(CPU)
    pd.register_file(P.FileSpec(1, 10 * MB, 0), 3)
    pd.track_task(1, (1,))
    col = mx.col_of(3)
    assert col > 0 and mx.col_of(5) == 0
    row = mx.row_of(1)
    assert int(mx.cnt[row, 0]) == 0 and int(mx.pbytes[row, 0]) == 0
    pd.drop_node(3)
    assert mx.col_of(3) == 0
    pd.register_file(P.FileSpec(2, 5 * MB, 0), 4)
    pd.track_task(2, (2,))
    assert mx.col_of(4) == col
    for f in range(3, 40):                       # 37 nodes, 37 tasks
        pd.register_file(P.FileSpec(f, f * MB, 0), f)
        pd.track_task(f, (f, 2))
    assert mx.cnt.shape[0] >= 37 and mx.cnt.shape[1] >= 38
    mx.check_against(pd)


# ------------------------------------------------------ hot node state
def test_node_capacity_array_stream_equal():
    """A random add/drop/re-join/mutate stream through compaction: every
    query of the port's tensors equals the reference's numpy arrays, in the
    same canonical order, and the tensors keep the reference's dtypes."""
    rng = random.Random(11)
    rnodes = {i: R.NodeState(i, rng.randint(2, 12) * GiB,
                             float(rng.randint(2, 16))) for i in range(40)}
    pnodes, _ = _port(rnodes.values())
    order = list(rnodes)
    rc = R.NodeCapacityArray(rnodes, order, 2)
    pc = P.NodeCapacityArray(pnodes, order, 2, device=CPU)
    assert (pc.free_mem.dtype, pc.free_cores.dtype, pc.mem.dtype,
            pc.active_cops.dtype) == (torch.int64, torch.float64,
                                      torch.int64, torch.int64)
    next_id = 40
    dead, compacted = 0, False
    for step in range(400):
        op = rng.randrange(6)
        live = list(rc.slot_of)
        if op == 0 or len(live) < 4:
            nid = rng.choice([next_id, rng.randrange(next_id)])
            if nid == next_id:
                next_id += 1
            if nid not in rc.slot_of:
                st = R.NodeState(nid, rng.randint(2, 12) * GiB,
                                 float(rng.randint(2, 16)))
                rnodes[nid] = st
                pnodes[nid] = _port([st])[0][nid]
                rc.add(nid, rnodes[nid])
                pc.add(nid, pnodes[nid])
        elif op == 1 or step % 3 == 0:
            nid = rng.choice(live)
            rc.drop(nid)
            pc.drop(nid)
        elif op == 2:
            nid = rng.choice(live)
            fm, fc = rng.randint(0, 12) * GiB, rng.uniform(0, 16)
            rc.set_free(nid, fm, fc)
            pc.set_free(nid, fm, fc)
        elif op == 3:
            nid = rng.choice(live)
            d = rng.choice([-1, 1])
            rc.add_cops(nid, d)
            pc.add_cops(nid, d)
        else:
            some = rng.sample(live, min(5, len(live)))
            for n in some:
                fm, ac = rng.randint(0, 12) * GiB, rng.randrange(3)
                for nodes in (rnodes, pnodes):
                    nodes[n].free_mem, nodes[n].active_cops = fm, ac
            rc.refresh_many(some, rnodes)
            pc.refresh_many(some, pnodes)
        compacted |= pc._dead < dead
        dead = pc._dead
        assert pc.slot_of == rc.slot_of and pc.version == rc.version
        assert pc.snapshot() == rc.snapshot()
        assert pc.live_ids() == rc.live_ids()
        mem, cores = rng.randrange(0, 9) * GiB, rng.uniform(0.0, 17.0)
        assert pc.fitting(mem, cores) == rc.fitting(mem, cores)
        assert pc.any_fit(mem, cores) == rc.any_fit(mem, cores)
        assert pc.fitting_with_slots(mem, cores)[1].tolist() == \
            rc.fitting_with_slots(mem, cores)[1].tolist()
        assert pc.free_slot_fit_ids(mem, cores) == \
            rc.free_slot_fit_ids(mem, cores)
        assert pc.free_slot_total_fit_ids(mem, cores) == \
            rc.free_slot_total_fit_ids(mem, cores)
        sub = [n for n in rc.live_ids() if rng.random() < 0.5]
        assert pc.filter_fitting(sub, mem, cores) == \
            rc.filter_fitting(sub, mem, cores)
    assert compacted, "the stream never compacted"


# --------------------------------------------------------------- topology
@pytest.mark.parametrize("spec", [
    {"rack_size": 4, "racks_per_site": 2},
    {"rack_size": 3, "racks_per_site": 0, "oversubscription": 2.0},
    {"rack_size": 32, "racks_per_site": 4, "oversubscription": 8.0},
    {"rack_size": 0}, {"rack_size": 64},
])
def test_topology_equal(spec):
    n = 40
    rt, pt = RTopology(RSpec(**spec), n, 100.0), PTopology(PSpec(**spec), n,
                                                           100.0)
    assert (pt.nonuniform, pt.n_racks, pt.n_sites, pt.rack_up_bw, pt.core_bw,
            pt.wan_bw, pt.max_weight) == \
        (rt.nonuniform, rt.n_racks, rt.n_sites, rt.rack_up_bw, rt.core_bw,
         rt.wan_bw, rt.max_weight)
    for a in range(0, n + 2, 3):
        for b in range(0, n + 2, 5):
            assert pt.distance(a, b) == rt.distance(a, b)
            assert pt.weight(a, b) == rt.weight(a, b)
            assert pt.path(a, b) == rt._path_uncached(a, b)
            links = (("up", a), ("down", b))
            assert pt.expand(links) == rt.expand(links)
            assert pt.tier(pt.expand(links)) == rt.tier(rt.expand(links))
    pcap, rcap = {}, {}
    for node in (0, 7, n, n + 33):
        pt.ensure_node(node, pcap)
        rt.ensure_node(node, rcap)
    assert pcap == rcap


# --------------------------------------------------------------- readyset
def test_ready_set_orders_equal():
    """The copied ReadySet, ShapeIndex and NodeOrder under one random
    stream answer as the reference's."""
    rng = random.Random(5)
    rr, pr = R.ReadySet(), P.ReadySet()
    rsi, psi = R.ShapeIndex(), P.ShapeIndex()
    ro, po = R.NodeOrder([3, 0, 2]), P.NodeOrder([3, 0, 2])
    for tid in range(200):
        op = rng.randrange(6)
        prio = round(rng.uniform(1, 5), 1)
        if op == 0:
            args = (tid, prio, rng.randrange(4), rng.randrange(3))
            blocked = rng.random() < 0.3
            rr.add(*args, blocked=blocked)
            pr.add(*args, blocked=blocked)
            shape = (rng.randrange(3), float(rng.randrange(3)))
            rsi.add(tid, *shape, prio)
            psi.add(tid, *shape, prio)
        elif op == 1 and len(rr):
            t = rng.choice(list(rr.step3_order()) or [0])
            prep, cops = rng.randrange(4), rng.randrange(3)
            for s in (rr, pr):
                s.update_prep(t, prep)
                s.update_cops(t, cops)
        elif op == 2:
            t = rng.randrange(tid + 1)
            for s in (rr, pr, rsi, psi):
                s.discard(t)
        elif op == 3:
            t = rng.randrange(tid + 1)
            b = rng.random() < 0.5
            rr.set_blocked(t, b)
            pr.set_blocked(t, b)
        elif op == 4:
            n, drop = rng.randrange(6), rng.random() < 0.5
            for o in (ro, po):
                o.discard(n) if drop else o.add(n)
        assert list(pr.step2_order()) == list(rr.step2_order())
        assert list(pr.step3_order()) == list(rr.step3_order())
        assert psi.shapes() == rsi.shapes()
        assert [psi.group(s) for s in psi.shapes()] == \
            [rsi.group(s) for s in rsi.shapes()]
        assert list(po) == list(ro)
