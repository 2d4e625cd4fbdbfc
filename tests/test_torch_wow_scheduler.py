"""The port's WOW scheduler (``repro_torch/core/scheduler.py``) and its
frozen oracle (``core/reference.py``) against the JAX package's on the CPU,
action for action.

* The batched drain scenario of ``benchmarks/scheduler_scale.py``
  (``_bd_build`` / ``_bd_wave``) at its smoke size, 32 nodes and 128 ready
  fan-in tasks, then 3 waves: flat, on the benchmark's ``site`` spec (one
  rack of 32 at this size, so flat again) and on racks of 4 nodes, 2 racks
  a site, where the locality cost row runs.  Every round's action stream
  of the port's blocked drain equals the reference's, the port's per-task
  oracle and its dict path equal it too, and the port's
  ``ReferenceWowScheduler`` equals the reference's.
* Random event streams with input-less and data-bound tasks, COP failures,
  declines, node failure and re-join under an old id, elastic joins.
* One test for each place where bit-identity could break on tensors:
  dtypes and sentinels, the locality row's order of additions, float floor
  division, per-shape mask caches and the free-slot mask re-read mid-loop,
  node order under recycled ids, and the fallbacks to the dict oracle.

Every seed is fixed."""
from __future__ import annotations

import dataclasses
import math
import random

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.sim import Topology as RTopology  # noqa: E402
from repro.sim import TopologySpec as RSpec  # noqa: E402
from repro_torch.bridge import actions_to_plain, wow_specs_from_plain  # noqa: E402,E501
from repro_torch.sim import Topology as PTopology  # noqa: E402
from repro_torch.sim import TopologySpec as PSpec  # noqa: E402

GiB = 1024 ** 3
CPU = "cpu"
TASK_MEM, TASK_CORES = 48 * GiB, 6.0     # benchmarks/scheduler_scale.py
TOPOS = {
    "flat": None,
    "site": {"rack_size": 32, "racks_per_site": 4, "oversubscription": 8.0},
    "racks": {"rack_size": 4, "racks_per_site": 2, "oversubscription": 8.0},
}
# the port's variants: the blocked drain, the per-task oracle, the dicts
VARIANTS = {"blocked": {}, "per_task": {"batched": False},
            "dict": {"vectorized": False}}


def _port_of(obj):
    """The port's copy of one reference dataclass instance."""
    kind = {"NodeState": "nodes", "TaskSpec": "tasks",
            "FileSpec": "files"}[type(obj).__name__]
    got = wow_specs_from_plain(**{kind: [dataclasses.asdict(obj)]})[kind]
    return next(iter(got.values()))


class Twins:
    """One reference scheduler and the port's schedulers under the same
    event stream.  ``ops`` are applied to every member; ``schedule()``
    returns the reference's actions as plain tuples after asserting that
    every port member produced the same."""

    def __init__(self, nodes, *, seed=0, topo=None, reference_core=False,
                 variants=VARIANTS, c_node=1, order=None):
        self.reference_core = reference_core
        self.members = []      # (package, nodes, dps, scheduler)
        pkgs = [(R, {})] + [(P, kw) for kw in variants.values()]
        for pkg, kw in pkgs:
            ns = {n: (s if pkg is R else _port_of(s))
                  for n, s in ((k, dataclasses.replace(v))
                               for k, v in nodes.items())}
            ord_ = pkg.NodeOrder(order if order is not None else ns)
            dev = {} if pkg is R else {"device": CPU}
            dps = pkg.DataPlacementService(seed=seed, node_order=ord_)
            if topo is not None:
                Topo, Spec = (RTopology, RSpec) if pkg is R else (PTopology,
                                                                  PSpec)
                dps.set_topology(Topo(Spec(**topo), len(ns), 100.0))
            if reference_core:
                sched = pkg.ReferenceWowScheduler(ns, dps, c_node=c_node,
                                                  node_order=ord_)
            else:
                sched = pkg.WowScheduler(ns, dps, c_node=c_node,
                                         node_order=ord_, **kw, **dev)
            self.members.append((pkg, ns, dps, sched))
            if reference_core:
                break                  # one port member: the oracle itself
        if reference_core:
            pkg = P
            ns = {n: _port_of(dataclasses.replace(v))
                  for n, v in nodes.items()}
            ord_ = P.NodeOrder(order if order is not None else ns)
            dps = P.DataPlacementService(seed=seed, node_order=ord_)
            if topo is not None:
                dps.set_topology(PTopology(PSpec(**topo), len(ns), 100.0))
            self.members.append((P, ns, dps, P.ReferenceWowScheduler(
                ns, dps, c_node=c_node, node_order=ord_)))

    @property
    def ref(self):
        return self.members[0][3]

    def each(self, fn):
        for pkg, nodes, dps, sched in self.members:
            fn(pkg, nodes, dps, sched)

    def register(self, fid, size, hosts):
        def go(pkg, nodes, dps, sched):
            dps.register_file(pkg.FileSpec(id=fid, size=size, producer=-1),
                              hosts[0])
            for h in hosts[1:]:
                dps.add_replica(fid, h)
        self.each(go)

    def submit(self, **spec):
        self.each(lambda pkg, n, d, s: s.submit(pkg.TaskSpec(**spec)))

    def finish_task(self, tid):
        node = self.ref.running[tid]
        self.each(lambda pkg, n, d, s: s.on_task_finished(tid, node))

    def finish_cop(self, cid, ok=True):
        self.each(lambda pkg, n, d, s: s.on_cop_finished(s.active_cops[cid],
                                                         ok))

    def schedule(self):
        want = None
        for pkg, _, _, sched in self.members:
            got = actions_to_plain(sched.schedule())
            if want is None:
                want = got
            else:
                assert got == want, (type(sched).__name__, got, want)
        return want


# ------------------------------------------------------- the drain scenario
def _drain(twins, rng, n_nodes, n_ready, waves=3):
    """benchmarks/scheduler_scale.py's drain: two fresh inputs a task on
    disjoint random hosts, each replicated 3 ways; a cold burst, then each
    wave finishes every running task and COP and submits one task a
    finished one.  Returns the rounds' action streams."""
    state = {"fid": 10 ** 6}

    def submit(tid):
        for _ in range(2):
            hosts = rng.sample(range(n_nodes), 3)
            twins.register(state["fid"], rng.randint(1, 4) * GiB, hosts)
            state["fid"] += 1
        twins.submit(id=tid, abstract="a", mem=TASK_MEM, cores=TASK_CORES,
                     inputs=(state["fid"] - 2, state["fid"] - 1),
                     priority=rng.uniform(1, 10))

    for t in range(n_ready):
        submit(t)
    rounds = [twins.schedule()]
    next_id = n_ready
    for _ in range(waves):
        finished = list(twins.ref.running)
        for tid in finished:
            twins.finish_task(tid)
        for cid in list(twins.ref.active_cops):
            twins.finish_cop(cid)
        for _ in range(len(finished)):
            submit(next_id)
            next_id += 1
        rounds.append(twins.schedule())
    return rounds


def _drain_nodes(n):
    return {i: R.NodeState(i, 128 * GiB, 16.0) for i in range(n)}


@pytest.mark.parametrize("topo", list(TOPOS))
def test_drain_smoke_equal(topo):
    twins = Twins(_drain_nodes(32), topo=TOPOS[topo])
    rounds = _drain(twins, random.Random(0), 32, 128)
    assert len(rounds) == 4 and all(rounds)
    assert sum(a[0] == "cop" for r in rounds for a in r) > 32
    blocked = twins.members[1][3]
    assert blocked.drain_stats["step2_kernel"] > 0
    assert twins.members[2][3].drain_stats["step2_kernel"] == 0
    ref = twins.ref
    assert (blocked.cops_created, blocked.tasks_started) == \
        (ref.cops_created, ref.tasks_started)
    assert blocked.inputless_stats == ref.inputless_stats
    drop = {"solve_s"}
    assert {k: v for k, v in blocked.solver_stats.items() if k not in drop} \
        == {k: v for k, v in ref.solver_stats.items() if k not in drop}


@pytest.mark.parametrize("topo", list(TOPOS))
def test_reference_scheduler_drain_equal(topo):
    """The frozen oracle: the port's ReferenceWowScheduler gives the
    reference's action streams on the same drain."""
    twins = Twins(_drain_nodes(32), topo=TOPOS[topo], reference_core=True)
    rounds = _drain(twins, random.Random(1), 32, 96, waves=2)
    assert sum(len(r) for r in rounds) > 32


# ----------------------------------------------------------- event streams
def _stream(twins, rng, steps, n_nodes, *, churn=True, declines=True):
    """A random stream: submissions (input-less, or reading existing and
    fresh files), task and COP completions (some COPs failing), declines,
    node failure and re-join under its old id, and elastic joins."""
    fid = tid = 0
    files: list[int] = []
    removed: list[int] = []
    ref_nodes = twins.members[0][1]
    next_node = n_nodes
    for step in range(steps):
        op = rng.randrange(10)
        if op < 4:
            k = rng.choice([0, 1, 1, 2, 3])
            inputs = []
            for _ in range(k):
                if files and rng.random() < 0.4:
                    inputs.append(rng.choice(files))
                else:
                    live = list(ref_nodes)
                    hosts = rng.sample(live, min(len(live),
                                                 rng.randint(1, 3)))
                    twins.register(fid, rng.randint(1, 8) * GiB, hosts)
                    files.append(fid)
                    inputs.append(fid)
                    fid += 1
            twins.submit(id=tid, abstract=f"a{tid % 3}",
                         mem=rng.randint(1, 6) * GiB,
                         cores=rng.choice([0.7, 1.0, 2.0, 2.5, 4.0]),
                         inputs=tuple(inputs),
                         priority=rng.choice([rng.uniform(1, 10), 5.0]))
            tid += 1
        elif op == 4 and twins.ref.running:
            twins.finish_task(rng.choice(sorted(twins.ref.running)))
        elif op == 5 and twins.ref.active_cops:
            twins.finish_cop(rng.choice(sorted(twins.ref.active_cops)),
                             ok=rng.random() < 0.8)
        elif op == 6 and declines and twins.ref.running:
            t = rng.choice(sorted(twins.ref.running))
            node = twins.ref.running[t]
            twins.each(lambda pkg, n, d, s: s.decline(t, node, "busy"))
        elif op == 7 and churn and len(ref_nodes) > 3:
            busy = set(twins.ref.running.values())
            idle = [n for n in ref_nodes if n not in busy]
            if idle:
                gone = rng.choice(idle)
                for cid, plan in sorted(twins.ref.active_cops.items()):
                    if gone in plan.nodes:
                        twins.finish_cop(cid, ok=False)

                def fail(pkg, nodes, dps, sched, gone=gone):
                    dps.drop_node(gone)
                    del nodes[gone]
                    sched.note_node_removed(gone)
                    sched.node_order.discard(gone)
                twins.each(fail)
                removed.append(gone)
        elif op == 8 and churn and (removed or rng.random() < 0.2):
            if removed and rng.random() < 0.7:
                nid = removed.pop(0)             # back under its old id
            else:
                nid, next_node = next_node, next_node + 1

            def join(pkg, nodes, dps, sched, nid=nid):
                nodes[nid] = pkg.NodeState(nid, 16 * GiB, 8.0)
                sched.node_order.add(nid)
                sched.note_node_added(nid)
            twins.each(join)
        twins.schedule()
    return tid


@pytest.mark.parametrize("seed", range(6))
def test_event_stream_equal(seed):
    nodes = {i: R.NodeState(i, 16 * GiB, 8.0) for i in range(6)}
    twins = Twins(nodes, seed=seed, c_node=1 + seed % 2)
    _stream(twins, random.Random(seed), 90, 6)
    port = twins.members[1][3]
    assert port.declines == twins.ref.declines
    assert port._cap_array.snapshot() == twins.ref._cap_array.snapshot()
    assert port._cap_array.live_ids() == twins.ref._cap_array.live_ids()


@pytest.mark.parametrize("seed", range(3))
def test_event_stream_on_racks_equal(seed):
    nodes = {i: R.NodeState(i, 16 * GiB, 8.0) for i in range(8)}
    twins = Twins(nodes, seed=seed, topo=TOPOS["racks"])
    _stream(twins, random.Random(50 + seed), 70, 8, churn=False)


@pytest.mark.parametrize("seed", range(3))
def test_reference_scheduler_stream_equal(seed):
    nodes = {i: R.NodeState(i, 16 * GiB, 8.0) for i in range(5)}
    twins = Twins(nodes, seed=seed, reference_core=True)
    _stream(twins, random.Random(80 + seed), 60, 5, churn=False,
            declines=False)


def test_non_ascending_node_order_equal():
    """Nodes enumerated out of id order share one NodeOrder: slots,
    candidates and decisions follow it in both packages."""
    ids = [3, 0, 2, 1, 5, 4]
    nodes = {i: R.NodeState(i, 16 * GiB, 8.0) for i in ids}
    twins = Twins(nodes, seed=4, order=ids)
    assert twins.members[1][3]._cap_array.live_ids() == ids
    _stream(twins, random.Random(4), 60, 6)


# --------------------------------------------------- the input-less path
def _inputless(twins, rng, shapes, steps, n_ready):
    tid = 0

    def submit():
        nonlocal tid
        mem, cores = rng.choice(shapes)
        twins.submit(id=tid, abstract="a", mem=mem, cores=cores, inputs=(),
                     priority=rng.choice([rng.uniform(1, 10), 5.0]))
        tid += 1

    for _ in range(n_ready):
        submit()
    for _ in range(steps):
        if rng.randrange(4) < 2:
            submit()
        elif twins.ref.running:
            twins.finish_task(rng.choice(sorted(twins.ref.running)))
        twins.schedule()


@pytest.mark.parametrize("shapes,fast", [
    ([(3 * GiB, 3.0)], "fast_solves"),                       # uniform greedy
    ([(3 * GiB, 0.7)], "fast_solves"),                       # float cores
    ([(2 * GiB, 0.7), (2 * GiB, 1.5), (3 * GiB, 2.5)], "trunc_solves"),
    ([(0, 0.7), (2 * GiB, 0.0)], "trunc_solves"),            # one-sided bounds
])
def test_inputless_paths_equal(shapes, fast):
    """A backlog past the exact gate takes ``_greedy_uniform_vec`` (one
    shape) or ``_truncate_component`` with ``_shape_capacity`` (several);
    both as tensor expressions give the reference's decisions and stats."""
    nodes = {i: R.NodeState(i, 8 * GiB, 7.0) for i in range(16)}
    twins = Twins(nodes)
    _inputless(twins, random.Random(len(shapes)), shapes, 30, 80)
    port = twins.members[1][3]
    assert port.inputless_stats == twins.ref.inputless_stats
    assert port.inputless_stats[fast] > 0


def test_float_floor_division_equals_numpy():
    """``free_cores // cores`` on float64 tensors floors as numpy and
    Python do (7.0 // 0.7 is 9.0, not 10.0), and ``_shape_capacity`` on the
    tensors equals the reference's on the arrays and the dict walk."""
    a = [1.0, 3.0, 0.7, 5.5, 7.0, 16.0, 1e-3]
    for b in (0.1, 0.7, 1.5, 0.3):
        got = (torch.tensor(a, dtype=torch.float64) // b).tolist()
        assert got == (np.asarray(a) // b).tolist() == [x // b for x in a]
    rnodes = {i: R.NodeState(i, 8 * GiB, 7.0, free_mem=(i % 5) * GiB,
                             free_cores=[0.7, 7.0, 6.9, 2.1, 0.0][i % 5])
              for i in range(10)}
    twins = Twins(rnodes)
    fit = list(rnodes)
    for shape in [(GiB, 0.7), (0, 0.7), (GiB, 0.0), (3 * GiB, 2.1),
                  (0, 0.0)]:
        want = twins.ref._shape_capacity(shape, fit)
        for _, _, _, sched in twins.members[1:]:
            assert sched._shape_capacity(shape, fit) == want, shape


# -------------------------------------------- where bit-identity could break
def test_drain_dtypes_and_sentinels():
    """Keys reach the winner as float64 under a topology and int64 flat,
    on the scheduler's device; ids are int64; the masks' sentinels are
    ``inf`` and int64 max."""
    seen = []
    for topo in ("flat", "racks"):
        twins = Twins(_drain_nodes(16), topo=TOPOS[topo],
                      variants={"blocked": {}})
        kern = twins.members[1][3]._kernel
        inner = kern._winner

        def spy(key, ids, inner=inner, topo=topo):
            seen.append((topo, key.dtype, ids.dtype, key.device.type))
            return inner(key, ids)
        kern._winner = spy
        _drain(twins, random.Random(2), 16, 48, waves=1)
    assert ("flat", torch.int64, torch.int64, "cpu") in seen
    assert ("racks", torch.float64, torch.int64, "cpu") in seen
    assert {s[:3] for s in seen} <= {("flat", torch.int64, torch.int64),
                                     ("racks", torch.float64, torch.int64)}
    assert P.torch_winner(CPU)(torch.tensor([math.inf, 2.0, 2.0],
                                            dtype=torch.float64),
                               torch.tensor([0, 9, 4])) == 4
    with pytest.raises(TypeError):
        P.torch_winner(CPU)(torch.zeros(3), torch.arange(3))


def test_locality_row_adds_file_by_file():
    """The locality cost row equals ``dps.locality_missing_cost`` on every
    slot, to the bit, for a task of many inputs whose sizes and weights
    make the order of additions show; a sum over files in another order
    does not equal it everywhere, which is why the row adds file by file."""
    rng = random.Random(9)
    topo = {"rack_size": 3, "racks_per_site": 2, "w_rack": 1.1,
            "w_site": 3.3, "w_wan": 17.1}
    nodes = {i: R.NodeState(i, 64 * GiB, 16.0) for i in range(18)}
    twins = Twins(nodes, topo=topo, variants={"blocked": {}})
    inputs = []
    for f in range(9):
        twins.register(f, rng.randint(1, 10 ** 9) * 7 + 3,
                       rng.sample(range(18), rng.randint(0, 3)) or [17])
        inputs.append(f)
    twins.each(lambda pkg, n, d, s: d.remove_replica(8, 17))  # no holder
    twins.submit(id=0, abstract="a", mem=128 * GiB, cores=1.0,
                 inputs=tuple(inputs + [2, 5]), priority=1.0)
    _, _, dps, sched = twins.members[1]
    row = sched._kernel._locality_cost_row(dps, 0).tolist()
    ref_dps = twins.members[0][2]
    want = [ref_dps.locality_missing_cost(0, n) for n in range(18)]
    assert row == want
    # the same terms summed largest file first
    terms = {n: [] for n in range(18)}
    topo_obj = dps.topology
    for f, m in dps._task_mult[0].items():
        locs = dps._locations.get(f, set())
        for n in range(18):
            if n in locs:
                continue
            w = (min(topo_obj.weight(h, n) for h in locs) if locs
                 else topo_obj.max_weight)
            terms[n].append(float(dps._files[f].size * m) * w)
    other = [sum(sorted(terms[n], reverse=True)) for n in range(18)]
    assert other != want


def test_fit_masks_cleared_and_free_slots_reread():
    """``begin()`` drops the per-shape fit masks of the last event, and the
    free-COP-slot mask is read again for each task: with one COP slot a
    node, a COP started for one task takes its nodes from the next task's
    candidates in the same ``schedule()``."""
    # nodes 0-2 hold one input each and have no free memory; 3-5 are free
    nodes = {i: R.NodeState(i, 8 * GiB, 8.0, free_mem=0 if i < 3 else None)
             for i in range(6)}
    twins = Twins(nodes, variants={"blocked": {}})
    for t in range(3):
        twins.register(t, (t + 1) * GiB, [t])
        twins.submit(id=t, abstract="a", mem=GiB, cores=1.0, inputs=(t,),
                     priority=3.0 - t)
    first = twins.schedule()
    cops = [a for a in first if a[0] == "cop"]
    assert [(a[2], a[3], a[4][0][2]) for a in cops] == \
        [(0, 3, 0), (1, 4, 1), (2, 5, 2)]
    kern = twins.members[1][3]._kernel
    assert kern._fit2 or kern._fit3
    kern.begin()
    assert not kern._fit2 and not kern._fit3


def test_fallbacks_take_the_dict_oracle():
    """An untracked task gets the -1 / None sentinels, and a constrained
    pool (an input whose only holders are busy) is answered by the dict
    oracle, in both cases as the reference answers."""
    nodes = {i: R.NodeState(i, 8 * GiB, 8.0) for i in range(4)}
    twins = Twins(nodes, variants={"blocked": {}})
    _, _, dps, sched = twins.members[1]
    kern = sched._kernel
    kern.begin()
    t = P.TaskSpec(id=9, abstract="a", mem=GiB, cores=1.0, inputs=(1,),
                   priority=1.0)
    assert kern.step2_winner(9, t, dps) == -1
    assert kern.step3_candidates(9, t) is None
    # file 0 on node 0 only, file 1 on node 1 only; nodes 0 and 1 have no
    # free memory.  Task 1 (no prepared node) goes first in step 2 and its
    # COP takes nodes 0 and 1; task 0's input then has no free source: its
    # pool is constrained, and the dict oracle answers it
    twins = Twins({i: R.NodeState(i, 8 * GiB, 8.0,
                                  free_mem=0 if i < 2 else None)
                   for i in range(4)}, variants={"blocked": {}})
    _, _, dps, sched = twins.members[1]
    twins.register(0, GiB, [0])
    twins.register(1, GiB, [1])
    twins.submit(id=0, abstract="a", mem=GiB, cores=1.0, inputs=(0,),
                 priority=2.0)
    twins.submit(id=1, abstract="a", mem=GiB, cores=1.0, inputs=(0, 1),
                 priority=1.0)
    acts = twins.schedule()
    assert [a[:4] for a in acts] == [("cop", 0, 1, 2)]
    assert sched.drain_stats["step2_kernel"] == 1
    assert sched.drain_stats["step2_oracle"] == 1
    assert sched._cap_array.free_mem.device.type == "cpu"
    assert dps.matrix.cnt.device.type == "cpu"


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = {0: P.NodeState(0, GiB, 1.0)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.WowScheduler(nodes, P.DataPlacementService(seed=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.make_adapter("wow", nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.make_adapter("cws", nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.torch_winner()
    dps = P.DataPlacementService(seed=0)
    with pytest.raises(ValueError, match="batched"):
        P.WowScheduler(nodes, dps, batched="jax", device=CPU)
    with pytest.raises(RuntimeError, match="vectorized"):
        P.WowScheduler(nodes, dps, vectorized=False, batched=True,
                       device=CPU)
    sched = P.WowScheduler(nodes, dps, device=CPU)
    assert sched.batched and sched.vectorized and sched._kernel is not None


def test_scheduler_refuses_a_dps_on_another_device():
    """A DPS whose COP matrix another scheduler put on another device is
    refused; the scheduler's own device is where it puts a fresh one."""
    nodes = {0: P.NodeState(0, GiB, 1.0)}
    dps = P.DataPlacementService(seed=0)
    dps.enable_matrix("meta")
    with pytest.raises(ValueError, match="meta"):
        P.WowScheduler(nodes, dps, device=CPU)
    fresh = P.DataPlacementService(seed=0)
    P.WowScheduler(nodes, fresh, device=CPU)
    assert fresh.matrix.cnt.device.type == "cpu"
