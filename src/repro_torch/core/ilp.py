"""Step-1 assignment solver (paper §III-B, "Start ready tasks on prepared
nodes"), incremental edition.

The problem: given ready tasks t_k = (mem, cores, N_prep, priority) and nodes
with free (mem, cores), choose a binary assignment a_{k,l} maximizing
sum(a_{k,l} * t_p) subject to

    * each task assigned at most once,
    * sum of assigned task memory  <= free node memory,
    * sum of assigned task cores   <= free node cores,
    * a_{k,l} = 0 unless node l is prepared for task k.

The paper solves this with OR-Tools (median 11 ms, always optimal < 2 s).
This container is offline, so we ship our own solver, organised in three
tiers (DESIGN.md "Step-1 solver"):

**Decomposition tier.** Because N_prep couples each task to only 1-2 nodes,
the global problem splits into many independent connected components of the
task <-> prepared-node bipartite graph.  ``decompose`` computes them;
``solve`` optimizes each component separately and merges.  Components are
where both optimality and speed come from: a 4096-task instance whose
largest component holds 8 tasks is 512 tiny problems, not one huge one.

**Exact / greedy tier (per component).**

* ``solve_exact``  -- depth-first branch & bound over tasks in priority
  order with an optimistic remaining-priority bound.  Optimal, and
  *canonical*: with a fixed branching order it always returns the first
  optimum in depth-first order, so independently solved components compose
  into exactly the assignment a monolithic B&B over the union would find.
* ``solve_greedy`` -- priority-descending best-fit with one
  swap-improvement pass; used beyond the exact budget (oversized
  components) and as the fallback when the B&B node budget is exhausted.

A component is solved exactly when it has <= ``_EXACT_CAND_LIMIT`` candidate
slots or <= ``_EXACT_TASK_LIMIT`` tasks -- per *component*, so decomposition
raises how often the answer is provably optimal versus the retained
monolithic gate.

**Incremental tier.** ``IncrementalAssignmentSolver`` keeps the component
structure alive between scheduler events.  The scheduler feeds it the dirty
task/node sets its event handlers recorded; only components touched by a
dirty task or node are dissolved and re-solved, every other component's
previous (empty -- see DESIGN.md) solution is reused untouched.  Re-solved
components first consult an LRU cache keyed by a canonical component
fingerprint (task shapes, priorities, candidate structure and node free
resources, all id-relative), so isomorphic subproblems recurring across
events are answered without searching.  On a cache miss the B&B incumbent
can be warm-started from the surviving previous assignment
(``strict_parity=False``); the default strict mode skips incumbent seeding
because a seeded search may return a different *tie-equivalent* optimum
than the canonical depth-first one, and the scheduler must stay
bit-identical to ``core.reference`` (equivalence-tested).

``solve_monolithic`` preserves the pre-decomposition behaviour verbatim
(exact-or-greedy over the whole instance); it is what
``core.reference.ReferenceWowScheduler`` runs and what the equivalence
tests compare against.

This is the reference's ``repro/core/ilp.py``, pure Python as it is there.
The B&B budget counts search nodes, not time, so a decision never depends
on the machine.  Where a capacity array is attached its tensors lie on the
scheduler's device; the gathers below read them through ``.tolist()``,
which yields the same Python ints and floats the dict walk reads.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Iterable, Mapping

from .types import NodeState, TaskSpec

# Budget of B&B nodes before falling back to greedy.  Exact instances in the
# paper are tiny; this bound keeps worst-case latency low at huge scale.
_EXACT_NODE_BUDGET = 200_000

# Exact tier limits, applied per component by `solve` and per whole instance
# by `solve_monolithic` (the retained reference gate).
_EXACT_CAND_LIMIT = 64
_EXACT_TASK_LIMIT = 24


def exact_gate(n_tasks: int, n_cand: int) -> bool:
    """True when an instance of ``n_tasks`` tasks with ``n_cand`` candidate
    slots qualifies for the exact (B&B) tier.  The single definition of the
    gate: `_solve_component` applies it per component, and the scheduler's
    input-less fast path keys its analytic-greedy branch on its negation --
    a bit-parity invariant, so external callers must use this function
    rather than re-deriving the thresholds."""
    return n_cand <= _EXACT_CAND_LIMIT or n_tasks <= _EXACT_TASK_LIMIT


@dataclasses.dataclass
class AssignmentProblem:
    tasks: list[TaskSpec]                      # candidate tasks (T_run)
    prepared: dict[int, list[int]]             # task id -> node ids (N_prep with free res.)
    nodes: dict[int, NodeState]
    # optional core.nodearray.NodeCapacityArray mirroring `nodes` (the
    # scheduler's vectorized hot state): candidate filtering then runs as
    # masked array gathers on the same values -- decisions identical
    cap: object | None = None

# Below this candidate-list length the per-element dict/attribute compare
# beats the tensor gather's setup cost; tiny lists (the common incremental
# component) keep the plain loop.
_MASK_MIN_CANDS = 16


def _free_maps(nodes: Mapping[int, NodeState], n_ids,
               cap) -> tuple[dict[int, int], dict[int, float]]:
    """``{node: free_mem}`` / ``{node: free_cores}`` for the solver's
    mutable capacity state.  With a capacity array attached and a
    non-tiny node set, both maps come from one masked gather each
    (``.tolist()`` yields plain Python ints/floats, so the values -- and
    every subsequent comparison -- are identical to the attribute reads);
    unknown ids fall back to the dict walk."""
    ids = list(n_ids)
    if cap is not None and len(ids) >= _MASK_MIN_CANDS:
        try:
            slots = cap.slots_of(ids)
        except KeyError:          # a node left the mirror: dict fallback
            pass
        else:
            return (dict(zip(ids, cap.free_mem[slots].tolist())),
                    dict(zip(ids, cap.free_cores[slots].tolist())))
    return ({n: nodes[n].free_mem for n in ids},
            {n: nodes[n].free_cores for n in ids})


def _feasible(problem: AssignmentProblem) -> AssignmentProblem:
    """Drop tasks with no prepared node that currently fits them.  With a
    capacity array attached, long candidate lists are filtered by one
    masked gather (`NodeCapacityArray.filter_fitting`, same values and
    order as the dict compare -- and no copy at all when everything fits,
    the common case for lists built from `fitting`)."""
    tasks, prepared = [], {}
    cap = problem.cap
    nodes = problem.nodes
    for t in problem.tasks:
        cand0 = problem.prepared.get(t.id, [])
        if cap is not None and len(cand0) >= _MASK_MIN_CANDS:
            cands = cap.filter_fitting(cand0, t.mem, t.cores)
        else:
            cands = [
                n for n in cand0
                if nodes[n].free_mem >= t.mem
                and nodes[n].free_cores >= t.cores
            ]
        if cands:
            tasks.append(t)
            prepared[t.id] = cands
    return AssignmentProblem(tasks, prepared, problem.nodes, cap)


def solve_exact(problem: AssignmentProblem,
                node_budget: int = _EXACT_NODE_BUDGET,
                incumbent: dict[int, int] | None = None) -> dict[int, int] | None:
    """Branch & bound.  Returns {task_id: node_id} or None if budget blown.

    ``incumbent`` optionally seeds the search with a known-feasible
    assignment (it must respect candidate membership and capacities; the
    incremental solver builds it from the previous event's solution).  The
    search then only explores strictly better solutions and returns the
    incumbent when none exists.  Seeding never lowers the objective but may
    select a different tie-equivalent optimum than the canonical unseeded
    search -- callers needing bit-parity with `solve_monolithic` must not
    seed.
    """
    p = _feasible(problem)
    tasks = sorted(p.tasks, key=lambda t: -t.priority)
    n_ids = sorted({n for cands in p.prepared.values() for n in cands})
    free_mem, free_cores = _free_maps(p.nodes, n_ids, p.cap)

    # suffix sums of priorities for the optimistic bound
    suffix = [0.0] * (len(tasks) + 1)
    for i in range(len(tasks) - 1, -1, -1):
        suffix[i] = suffix[i + 1] + tasks[i].priority

    best_val = -1.0
    best_assign: dict[int, int] = {}
    if incumbent:
        # Keep only entries that survived _feasible; value is summed in the
        # solver's task order so ties between equal-multiset optima compare
        # bit-identically.
        best_assign = {tid: n for tid, n in incumbent.items()
                       if n in p.prepared.get(tid, ())}
        # accumulate in the same (reversed-task) order as the suffix bound:
        # a fully surviving incumbent then equals suffix[0] bit-exactly, so
        # the root prune closes the search immediately instead of losing to
        # float non-associativity by one ulp and re-searching everything
        best_val = 0.0
        for i in range(len(tasks) - 1, -1, -1):
            if tasks[i].id in best_assign:
                best_val = best_val + tasks[i].priority
    cur_assign: dict[int, int] = {}
    visited = 0
    aborted = False

    def rec(i: int, val: float) -> None:
        nonlocal best_val, best_assign, visited, aborted
        if aborted:
            return
        visited += 1
        if visited > node_budget:
            aborted = True
            return
        if val + suffix[i] <= best_val:
            return  # cannot beat incumbent
        if i == len(tasks):
            if val > best_val:
                best_val = val
                best_assign = dict(cur_assign)
            return
        t = tasks[i]
        # branch: assign to each feasible prepared node (greedy order helps
        # the bound: most-free node first)
        cands = sorted(
            (n for n in p.prepared[t.id]
             if free_mem[n] >= t.mem and free_cores[n] >= t.cores),
            key=lambda n: (-(free_cores[n]), -(free_mem[n]), n),
        )
        for n in cands:
            free_mem[n] -= t.mem
            free_cores[n] -= t.cores
            cur_assign[t.id] = n
            rec(i + 1, val + t.priority)
            del cur_assign[t.id]
            free_mem[n] += t.mem
            free_cores[n] += t.cores
            if aborted:
                return
        # branch: skip the task
        rec(i + 1, val)

    rec(0, 0.0)
    if aborted:
        return None
    return best_assign


def solve_greedy(problem: AssignmentProblem) -> dict[int, int]:
    """Priority-descending best-fit + one swap/repair pass.

    Deterministic; O(T log T + T * |N_prep|).  At paper scale |N_prep| is
    tiny, so this is effectively linear in the number of ready tasks.
    Operates within a single component exactly like it operates on the
    union of components (placements only touch the component's own nodes),
    so the decomposed and monolithic greedy paths agree.
    """
    p = _feasible(problem)
    tasks = sorted(p.tasks, key=lambda t: (-t.priority, t.id))
    # only candidate-referenced nodes are ever indexed below; restricting
    # the free dicts to them drops an O(all nodes) walk for callers that
    # pass the full node dict
    n_ids = {n for cands in p.prepared.values() for n in cands}
    free_mem, free_cores = _free_maps(p.nodes, n_ids, p.cap)
    assign: dict[int, int] = {}

    def try_place(t: TaskSpec) -> bool:
        cands = [n for n in p.prepared[t.id]
                 if free_mem[n] >= t.mem and free_cores[n] >= t.cores]
        if not cands:
            return False
        # best-fit: leave the *most* slack elsewhere -> place on the node
        # where the task wastes the least spare capacity
        n = min(cands, key=lambda n: (free_cores[n] - t.cores,
                                      free_mem[n] - t.mem, n))
        assign[t.id] = n
        free_mem[n] -= t.mem
        free_cores[n] -= t.cores
        return True

    skipped: list[TaskSpec] = []
    for t in tasks:
        if not try_place(t):
            skipped.append(t)

    # repair pass: a skipped higher-priority task may fit if we relocate one
    # placed task to another of its prepared nodes.
    by_id = {t.id: t for t in tasks}
    for t in skipped:
        placed_here = [
            (tid, n) for tid, n in assign.items()
            if n in p.prepared[t.id] and by_id[tid].priority < t.priority
        ]
        done = False
        for tid, n in sorted(placed_here, key=lambda kv: by_id[kv[0]].priority):
            other = by_id[tid]
            # can `other` move somewhere else?
            for m in p.prepared[other.id]:
                if m == n:
                    continue
                if free_mem[m] >= other.mem and free_cores[m] >= other.cores:
                    # relocate other -> m
                    free_mem[n] += other.mem
                    free_cores[n] += other.cores
                    free_mem[m] -= other.mem
                    free_cores[m] -= other.cores
                    assign[other.id] = m
                    if free_mem[n] >= t.mem and free_cores[n] >= t.cores:
                        assign[t.id] = n
                        free_mem[n] -= t.mem
                        free_cores[n] -= t.cores
                        done = True
                    break
            if done:
                break
    return assign


def objective(problem: AssignmentProblem, assign: dict[int, int]) -> float:
    by_id = {t.id: t for t in problem.tasks}
    return sum(by_id[tid].priority for tid in assign)


def solve_monolithic(problem: AssignmentProblem) -> dict[int, int]:
    """Pre-decomposition solver, retained verbatim: exact when the *whole*
    instance is affordable, greedy otherwise (mirrors the paper's 10 s
    OR-Tools cut-off, which their experiments never hit).  This is the
    behavioural reference `core.reference.ReferenceWowScheduler` runs; do
    not optimise it."""
    n_cand = sum(len(v) for v in problem.prepared.values())
    if n_cand <= _EXACT_CAND_LIMIT or len(problem.tasks) <= _EXACT_TASK_LIMIT:
        exact = solve_exact(problem)
        if exact is not None:
            greedy = solve_greedy(problem)
            # exact is optimal, but keep the safer of the two in case the
            # bound aborted mid-way (exact returns None then, handled below)
            if objective(problem, exact) >= objective(problem, greedy):
                return exact
            return greedy
    return solve_greedy(problem)


# ------------------------------------------------------------- decomposition
def group_by_shared_nodes(keys: list, cand_of) -> list[list]:
    """Union-find over ``keys`` via shared candidate nodes (``cand_of(key)``
    yields a key's node ids).  The earliest key wins as a group's root, so
    groups are ordered by first appearance and intra-group order follows
    ``keys`` -- the single grouping both the stateless and the incremental
    solver use, which is what keeps their partitions identical."""
    pos = {k: i for i, k in enumerate(keys)}
    parent = {k: k for k in keys}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra == rb:
            return
        if pos[ra] > pos[rb]:           # earliest key wins: deterministic
            ra, rb = rb, ra
        parent[rb] = ra

    node_owner: dict[int, int] = {}
    for k in keys:
        for n in cand_of(k):
            o = node_owner.setdefault(n, k)
            if o != k:
                union(k, o)

    groups: dict[int, list[int]] = {}
    for k in keys:
        groups.setdefault(find(k), []).append(k)
    return [groups[r] for r in sorted(groups, key=pos.__getitem__)]


def _components(p: AssignmentProblem) -> list[tuple[list[TaskSpec],
                                                    dict[int, list[int]],
                                                    list[int]]]:
    """Connected components of the task<->candidate-node bipartite graph of
    an already-`_feasible` problem.  Returns (tasks, candidates, node ids)
    triples; component order and intra-component task order both follow the
    input task order, node ids are ascending."""
    by_id = {t.id: t for t in p.tasks}
    out = []
    for group in group_by_shared_nodes([t.id for t in p.tasks],
                                       p.prepared.__getitem__):
        tasks = [by_id[tid] for tid in group]
        cand = {tid: p.prepared[tid] for tid in group}
        node_ids = sorted({n for c in cand.values() for n in c})
        out.append((tasks, cand, node_ids))
    return out


def decompose(problem: AssignmentProblem) -> list[AssignmentProblem]:
    """Split a problem into independent subproblems (public diagnostic API;
    `solve` uses the same partition internally)."""
    p = _feasible(problem)
    return [AssignmentProblem(tasks, cand, {n: p.nodes[n] for n in node_ids},
                              p.cap)
            for tasks, cand, node_ids in _components(p)]


def _solve_component(tasks: list[TaskSpec], cand: dict[int, list[int]],
                     nodes: dict[int, NodeState],
                     seed: dict[int, int] | None = None,
                     node_budget: int = _EXACT_NODE_BUDGET,
                     cap: object | None = None,
                     ) -> tuple[dict[int, int], str]:
    """One component: exact when small (per-component gate), else greedy.
    Returns (assignment, tier) with tier in {"exact", "greedy", "aborted"}.
    ``cand`` lists must already be filtered to currently-fitting nodes."""
    prob = AssignmentProblem(tasks, cand, nodes, cap)
    n_cand = sum(len(v) for v in cand.values())
    if exact_gate(len(tasks), n_cand):
        exact = solve_exact(prob, node_budget, incumbent=seed)
        if exact is not None:
            return exact, "exact"
        greedy = solve_greedy(prob)
        if seed and objective(prob, seed) > objective(prob, greedy):
            # the seeded incumbent is known-feasible; don't return a worse
            # greedy result just because the search aborted
            return dict(seed), "aborted"
        return greedy, "aborted"
    return solve_greedy(prob), "greedy"


def solve(problem: AssignmentProblem) -> dict[int, int]:
    """Stateless entry point: decompose, solve each component (exact under
    the per-component gate, greedy beyond it), merge.  Matches
    `solve_monolithic` bit-for-bit whenever the monolithic gate would have
    gone exact, and is never worse in objective value."""
    p = _feasible(problem)
    assign: dict[int, int] = {}
    for tasks, cand, node_ids in _components(p):
        sub, _tier = _solve_component(
            tasks, cand, {n: p.nodes[n] for n in node_ids}, cap=p.cap)
        assign.update(sub)
    return assign


# ------------------------------------------------------- fingerprint caching
def component_fingerprint(tids, tasks: Mapping[int, TaskSpec],
                          cand: Mapping[int, list[int]],
                          nodes: Mapping[int, NodeState],
                          cap=None):
    """Canonical fingerprint of one component: everything the tiered solve's
    decisions can depend on (task shapes, priorities, candidate structure,
    node free resources), expressed id-relative so isomorphic components
    recurring across events -- or across callers -- compare equal.  id ranks
    are included because greedy tie-breaks on task id and candidate order
    tie-breaks on node id.  Returns ``(fp, nlist, npos)`` where ``nlist`` is
    the component's node ids ascending and ``npos`` their positions, the
    coordinates :class:`FingerprintCache` encodes assignments in.  With a
    capacity array the node free tuples come from one gather (plain Python
    ints/floats via ``.tolist()``, so fingerprints compare equal across the
    gathered and walked forms)."""
    nlist = sorted({n for c in cand.values() for n in c})
    npos = {n: i for i, n in enumerate(nlist)}
    id_rank = {t: i for i, t in enumerate(sorted(tids))}
    node_fp = None
    if cap is not None and len(nlist) >= _MASK_MIN_CANDS:
        try:
            slots = cap.slots_of(nlist)
        except KeyError:          # a node left the mirror: dict fallback
            pass
        else:
            node_fp = tuple(zip(cap.free_mem[slots].tolist(),
                                cap.free_cores[slots].tolist()))
    if node_fp is None:
        node_fp = tuple((nodes[n].free_mem, nodes[n].free_cores)
                        for n in nlist)
    fp = (
        tuple((id_rank[t], tasks[t].mem, tasks[t].cores,
               tasks[t].priority,
               tuple(npos[n] for n in cand[t])) for t in tids),
        node_fp,
    )
    return fp, nlist, npos


class FingerprintCache:
    """LRU of component solutions keyed by :func:`component_fingerprint`,
    stored position-relative (task position, node position) so one cached
    solution serves every isomorphic instance.  Shared machinery of the
    incremental step-1 solver and the scheduler's input-less capacity path
    (DESIGN.md "Incremental input-less placement")."""

    def __init__(self, size: int = 2048) -> None:
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._size = size

    def get(self, fp: tuple, tids: list[int],
            nlist: list[int]) -> dict[int, int] | None:
        hit = self._entries.get(fp)
        if hit is None:
            return None
        self._entries.move_to_end(fp)
        return {tids[ti]: nlist[ni] for ti, ni in hit}

    def put(self, fp: tuple, tids: list[int], npos: dict[int, int],
            assign: dict[int, int]) -> None:
        tpos = {t: i for i, t in enumerate(tids)}
        self._entries[fp] = tuple(sorted(
            (tpos[t], npos[n]) for t, n in assign.items()))
        if len(self._entries) > self._size:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------- incremental tier
class IncrementalAssignmentSolver:
    """Event-driven step-1 solver with persistent component structure.

    Contract with the scheduler (DESIGN.md "Step-1 solver"):

    * ``candidates`` passed to :meth:`solve_event` maps every currently
      startable task to its list of prepared nodes that fit it, in
      canonical node order; between events an entry may only change if the
      scheduler marked the task dirty (the DPS dirties tasks on replica
      changes, dirty nodes are expanded to the tasks prepared on them).
      Input-less tasks normally bypass this solver via the scheduler's
      capacity-only fast path (DESIGN.md "Input-less fast path") and enter
      ``candidates`` -- always accompanied by their ids in ``dirty_tasks``
      -- only on mixed events where they must be solved jointly with
      startable data-bound tasks.
    * ``dirty_nodes`` contains every node whose free resources changed
      since the previous event (task finished, step-1 reservation, elastic
      join).
    * every applied assignment dirties the assigned nodes, and a caller
      that *declines* part of an assignment (an external resource manager
      may reject placements) must mark the declined tasks dirty again --
      either way a component with a non-empty solution is re-solved next
      event, which is why a component left untouched by the dirty sets
      necessarily carries an empty solution and can be skipped wholesale.

    Components touched by a dirty task/node (transitively, through shared
    candidate nodes) are dissolved and rebuilt with a union-find over the
    current candidate lists, then re-solved through a canonical-fingerprint
    LRU cache; with ``strict_parity=False`` cache misses additionally seed
    the B&B incumbent from the surviving previous assignment (same
    objective, possibly different tie-breaks -- keep the default when
    bit-parity with the reference scheduler matters).  Note the seed can
    only be non-empty for tasks whose previous assignment was *declined*
    by the caller (applied tasks leave the candidate set), so warm starts
    matter exactly on the resource-manager-rejection path.
    """

    def __init__(self, nodes: dict[int, NodeState], *,
                 strict_parity: bool = True, cache_size: int = 2048,
                 cap: object | None = None) -> None:
        self.nodes = nodes
        self.cap = cap          # optional NodeCapacityArray mirror of nodes
        self.strict_parity = strict_parity
        self._cache = FingerprintCache(cache_size)
        self._comp_tasks: dict[int, list[int]] = {}    # cid -> tids (seq order)
        self._comp_nodes: dict[int, frozenset[int]] = {}
        self._comp_assign: dict[int, dict[int, int]] = {}
        self._task_comp: dict[int, int] = {}
        self._node_comp: dict[int, int] = {}
        self._next_cid = 0
        self.stats: dict[str, float] = {
            "events": 0, "comps_rebuilt": 0, "comps_reused": 0,
            "cache_hits": 0, "cache_misses": 0, "exact_solves": 0,
            "greedy_solves": 0, "budget_aborts": 0, "warm_seeds": 0,
            "solve_s": 0.0,
        }

    # ------------------------------------------------------------ event API
    def solve_event(self, tasks: Mapping[int, TaskSpec],
                    candidates: Mapping[int, list[int]],
                    seq: Mapping[int, int],
                    dirty_tasks: Iterable[int],
                    dirty_nodes: Iterable[int]) -> dict[int, int]:
        """Re-solve exactly the components touched by the dirty sets and
        return their merged assignment (untouched components contribute
        nothing by the empty-solution invariant above).

        ``seq`` orders tasks by submission (FIFO): it fixes the solver-input
        order inside each component, which is what makes decomposed results
        identical to a monolithic solve over the same instance.
        """
        t0 = time.perf_counter()
        try:
            return self._solve_event(tasks, candidates, seq,
                                     dirty_tasks, dirty_nodes)
        finally:
            self.stats["solve_s"] += time.perf_counter() - t0

    def _solve_event(self, tasks, candidates, seq, dirty_tasks, dirty_nodes):
        self.stats["events"] += 1
        pending: set[int] = set()
        prev: dict[int, int] = {}       # last solutions of dissolved comps
        work: list[int] = []

        def dissolve(cid: int) -> None:
            tids = self._comp_tasks.pop(cid, None)
            if tids is None:
                return
            prev.update(self._comp_assign.pop(cid, {}))
            for t in tids:
                self._task_comp.pop(t, None)
                if t in candidates and t not in pending:
                    pending.add(t)
                    work.append(t)
            for n in self._comp_nodes.pop(cid):
                self._node_comp.pop(n, None)

        for t in dirty_tasks:
            cid = self._task_comp.get(t)
            if cid is not None:
                dissolve(cid)
            if t in candidates and t not in pending:
                pending.add(t)
                work.append(t)
        for n in dirty_nodes:
            cid = self._node_comp.get(n)
            if cid is not None:
                dissolve(cid)
        # closure: a rebuilt task may now share a candidate node with a
        # still-live component -- merge it in by dissolving that one too
        while work:
            t = work.pop()
            for n in candidates.get(t, ()):
                cid = self._node_comp.get(n)
                if cid is not None:
                    dissolve(cid)
        self.stats["comps_reused"] += len(self._comp_tasks)
        if not pending:
            return {}

        # regroup the pending tasks (submission order) into components
        ptasks = sorted(pending, key=seq.__getitem__)
        out: dict[int, int] = {}
        for tids in group_by_shared_nodes(ptasks, candidates.__getitem__):
            assign = self._solve_comp(tids, tasks, candidates, prev)
            cid = self._next_cid
            self._next_cid += 1
            nodeset = frozenset(n for t in tids for n in candidates[t])
            self._comp_tasks[cid] = tids
            self._comp_nodes[cid] = nodeset
            self._comp_assign[cid] = assign
            for t in tids:
                self._task_comp[t] = cid
            for n in nodeset:
                self._node_comp[n] = cid
            out.update(assign)
            self.stats["comps_rebuilt"] += 1
        return out

    # -------------------------------------------------------------- helpers
    def _solve_comp(self, tids, tasks, candidates, prev):
        cand = {t: candidates[t] for t in tids}
        fp, nlist, npos = component_fingerprint(tids, tasks, cand, self.nodes,
                                                cap=self.cap)
        hit = self._cache.get(fp, tids, nlist)
        if hit is not None:
            self.stats["cache_hits"] += 1
            return hit
        self.stats["cache_misses"] += 1

        seed = None
        if not self.strict_parity and prev:
            seed = self._warm_seed(tids, tasks, cand, prev)
        t_specs = [tasks[t] for t in tids]
        node_states = {n: self.nodes[n] for n in nlist}
        assign, tier = _solve_component(t_specs, cand, node_states, seed=seed,
                                        cap=self.cap)
        if tier == "exact":
            self.stats["exact_solves"] += 1
        else:
            self.stats["greedy_solves"] += 1
            if tier == "aborted":
                self.stats["budget_aborts"] += 1

        self._cache.put(fp, tids, npos, assign)
        return assign

    def _warm_seed(self, tids, tasks, cand, prev):
        """Feasible sub-assignment surviving from the previous event's
        solution of the dissolved components, used to seed the B&B
        incumbent (non-strict mode only)."""
        seed: dict[int, int] = {}
        used_mem: dict[int, int] = {}
        used_cores: dict[int, float] = {}
        for t in tids:
            n = prev.get(t)
            if n is None or n not in cand[t]:
                continue
            spec = tasks[t]
            nm = used_mem.get(n, 0) + spec.mem
            nc = used_cores.get(n, 0.0) + spec.cores
            if nm <= self.nodes[n].free_mem and nc <= self.nodes[n].free_cores:
                seed[t] = n
                used_mem[n] = nm
                used_cores[n] = nc
        if seed:
            self.stats["warm_seeds"] += 1
            return seed
        return None
