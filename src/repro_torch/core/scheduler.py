"""The WOW three-step scheduler (paper §III-B), dirty-set edition: the
reference's ``repro/core/scheduler.py`` with its hot node state, its COP
matrix and its blocked drain on torch tensors on ``device``.

Driven by an environment (the mock resource manager, or any runtime behind
the adapter API) through a narrow event interface:

    submit(task)                  -- task entered the job queue (ready)
    on_task_finished(task, node)  -- frees node resources
    on_cop_finished(plan, ok)     -- commits replicas, frees COP slots
    note_node_added(node)         -- elastic join
    note_node_removed(node)       -- node failed / left
    schedule() -> [Action]        -- runs steps 1..3, reserves resources for
                                     StartTask actions it returns

The environment applies the returned actions, advances time, and calls
``schedule()`` again after every event (task finished / COP finished / task
submitted), exactly like the paper's iteration loop.

Incremental contract (DESIGN.md "Dirty-set contracts"): instead of rescanning
all ready tasks x all nodes per event, every event marks only what it
touched --

  * ``submit`` marks the new task dirty (and registers it with the DPS so
    its prepared-node set is maintained incrementally),
  * ``on_task_finished`` marks the freed *node* dirty,
  * ``on_cop_finished`` updates the free-COP-slot set; the replica commit
    marks affected consumer tasks dirty inside the DPS,
  * step-1 reservations mark the assigned nodes dirty.

``schedule()`` expands dirty nodes to the tasks prepared on them (via the
DPS reverse index), refreshes the cached start candidates for exactly the
dirty tasks, and hands both dirty sets to the incremental step-1 solver
(`core.ilp.IncrementalAssignmentSolver`), which re-solves only the
connected components of the task/prepared-node graph the dirty sets touch.

Three further indexed structures (DESIGN.md "Indexed ready set") remove the
remaining per-event O(backlog) scans:

  * **Input-less fast path.**  Ready tasks with no intermediate inputs are
    prepared everywhere -- pure capacity placement.  They never enter the
    DPS or the incremental solver's component structure (which they used to
    weld into one always-dirty component); their step-1 subproblem is built
    per *shape* from `readyset.ShapeIndex` (pre-sorted greedy order,
    maintained under submit/start) and `readyset.CapacityClasses` (all
    fitting nodes per shape), then solved per shape-component by the
    cheapest decision-identical tier: an analytic uniform-shape greedy for
    large single-shape components, else `ilp.solve` behind the canonical
    fingerprint cache -- O(shapes + assigned) per stale fan-out event
    instead of O(backlog), with decisions unchanged (DESIGN.md
    "Incremental input-less placement").  On the rare event where
    input-less *and* data-bound tasks are startable at once the two
    subproblems could compete for capacity, and the scheduler falls back
    to one joint solve -- bit-equal to the always-joint behaviour by
    construction.
  * **Indexed steps 2-3.**  `readyset.ReadySet` keeps every data-bound
    ready task pre-sorted under both step orders, updated in O(log R) as
    DPS prepared-counts and per-task COP counts change; tasks whose COP is
    provably infeasible under the current free-slot set (`dps.cop_blocked`)
    are parked out of both orders, so steps 2-3 visit only tasks that could
    actually start a COP -- no per-event sort, no backlog-wide probe loop.
  * **Canonical node order.**  A `readyset.NodeOrder` owned by the
    environment (or created here for standalone use) replaces every
    ``sorted(self.nodes)`` and defines candidate/iteration order the same
    way the reference's ``list(self.nodes)`` scans do, lifting the old
    "node ids ascend" convention (nodes may re-join under old ids).
  * **Batched COP drain** (``batched=True``, default whenever
    ``vectorized``; DESIGN.md "Batched COP drain").  The DPS maintains a
    dense (task x node-slot) present-count / present-bytes matrix
    (`core.copmatrix.CopMatrix`) at its replica-mutation choke points, and
    a `core.copmatrix.BlockedDrainKernel` replaces the per-task inner
    machinery of steps 2-3: candidate masks, missing-bytes / locality-cost
    rows and the step-2 argmin become array expressions in canonical slot
    order, with staged reductions that split float ties exactly as the
    dict tuple-compare.  Only the *winning* step-2 probe reaches scalar
    ``plan_cop`` (provably always feasible for the unconstrained pool), so
    COP-id and tie-break RNG consumption is unchanged; step-3 keeps its
    scalar probe-all loop (each feasible probe consumes a COP id) and only
    the candidate construction is blocked.  The per-task dict machinery is
    retained verbatim as the oracle (``batched=False``), property-tested
    bit-identical; constrained pools always take the oracle path.

The device changes no decision: the tensors hold the reference's dtypes
(int64 memory and bytes, float64 cores and costs), and every reduction
breaks ties as the reference's numpy path does.  ``vectorized=False`` keeps
the per-node dict oracle, ``batched=False`` the per-task drain; Python
dicts, heaps and sets stay host-side on every path.  Scalar reads of device
tensors in the per-event loops each cost a sync on a card: this module asks
the card for correctness, not speed.

Decisions are bit-identical to ``core.reference.ReferenceWowScheduler``
(equivalence-tested), with one deliberate, documented exception: where the
reference's monolithic solver falls back to greedy (instances beyond its
exact gate of > 24 tasks AND > 64 candidate slots, or a B&B that exhausts
its node budget on the product search tree) the incremental solver still
solves small *components* exactly, so it may pick a different (never worse)
tie-equivalent optimum -- see DESIGN.md "Step-1 solver".
"""
from __future__ import annotations

import math
import time

import torch

from ..models.common import require_device
from .copmatrix import BlockedDrainKernel
from .dps import DataPlacementService
from .ilp import (AssignmentProblem, FingerprintCache,
                  IncrementalAssignmentSolver, component_fingerprint,
                  exact_gate, group_by_shared_nodes, solve_greedy)
from .ilp import solve as solve_stateless
from .nodearray import ArrayCapacityClasses, NodeCapacityArray
from .readyset import CapacityClasses, NodeOrder, ReadySet, ShapeIndex
from .types import (Action, CopPlan, NodeState, StartCop, StartTask, TaskSpec)

_BIG = torch.iinfo(torch.int64).max


class WowScheduler:
    def __init__(
        self,
        nodes: dict[int, NodeState],
        dps: DataPlacementService,
        c_node: int = 1,
        c_task: int = 2,
        node_order: NodeOrder | None = None,
        vectorized: bool = True,
        strict_parity: bool = True,
        batched: bool | None = None,
        device="cuda",
    ) -> None:
        # the device of the hot node state, the DPS's COP matrix and the
        # drain; CUDA unless the caller names another
        self.device = require_device(device)
        self.nodes = nodes
        self.dps = dps
        self.c_node = c_node
        self.c_task = c_task
        # strict_parity=False lets the step-1 solver seed its B&B incumbent
        # from surviving previous assignments -- pays off exactly when a
        # runtime declines placements (core/adapter.py decline-requeue path)
        self.strict_parity = bool(strict_parity)
        # vectorized hot node state (tensors on the device); the dict path
        # is the retained oracle, and decisions are bit-identical either way
        self.vectorized = bool(vectorized)
        # batched step-2/3 drain: None = on exactly when the node state is
        # vectorized.  The per-task dict machinery is the retained oracle.
        # The reference's batched="jax" has no counterpart: the batched
        # path is the torch reduction on the device.
        if batched is None:
            batched = self.vectorized
        if not isinstance(batched, bool):
            raise ValueError(f"batched must be True, False or None; got "
                             f"{batched!r}")
        if batched and not self.vectorized:
            raise RuntimeError("batched drain requires vectorized node "
                               "state; pass batched=False (per-task "
                               "oracle) instead")
        self.batched = batched
        # canonical node enumeration order; the environment passes its own
        # (sim/engine.py owns one), standalone use derives it from the dict
        self.node_order = node_order if node_order is not None \
            else NodeOrder(nodes)

        self.ready: dict[int, TaskSpec] = {}
        self.running: dict[int, int] = {}          # task id -> node
        self.active_cops: dict[int, CopPlan] = {}
        self.cops_per_task: dict[int, int] = {}
        self.inflight_targets: set[tuple[int, int]] = set()  # (task, node)
        # per-task view of inflight_targets (task -> target nodes), updated
        # at the same two choke points; the blocked kernel clears these few
        # mask entries instead of testing (tid, n) per candidate
        self._inflight_by_task: dict[int, set[int]] = {}
        self._finished_specs: dict[int, TaskSpec] = {}
        # metrics hooks
        self.cops_created: int = 0
        self.tasks_started: int = 0
        self.declines: int = 0
        # per-phase wall time (benchmarks): step 1 overall, its input-less
        # share, and steps 2-3 together
        self.phase_s: dict[str, float] = {
            "step1_s": 0.0, "inputless_s": 0.0, "step23_s": 0.0}
        # which path answered each step-2/3 task: the blocked drain on the
        # device, or the per-task dict oracle (constrained pools, untracked
        # rows, batched=False)
        self.drain_stats: dict[str, int] = {
            "step2_kernel": 0, "step3_kernel": 0, "step2_oracle": 0,
            "step3_oracle": 0}

        # ----- incremental state (see module docstring)
        self._seq = 0
        self._submit_seq: dict[int, int] = {}      # ILP task order = FIFO
        self._dirty_tasks: set[int] = set()
        self._dirty_nodes: set[int] = set()
        self._less_stale = True                    # input-less path dirty?
        # input-less ready tasks (prepared everywhere) live in the shape
        # index only: shape -> (-priority, id)-sorted buckets, plus the
        # fingerprint cache for the recurring capacity subproblem (DESIGN.md
        # "Incremental input-less placement")
        self._less_index = ShapeIndex()
        self._less_cache = FingerprintCache()
        self.inputless_stats: dict[str, int] = {
            "events": 0, "fast_solves": 0, "trunc_solves": 0,
            "cache_hits": 0, "cache_misses": 0, "joint_events": 0}
        self._startable: dict[int, list[int]] = {} # cached prep ∩ fits, != []
        self._free_slot_nodes: set[int] = {
            n for n, s in nodes.items() if s.active_cops < c_node}
        if self.vectorized:
            self._cap_array: NodeCapacityArray | None = NodeCapacityArray(
                nodes, self.node_order, c_node, self.device)
            self._capacity = ArrayCapacityClasses(self._cap_array, nodes)
        else:
            self._cap_array = None
            self._capacity = CapacityClasses(nodes, self.node_order)
        self._ready_index = ReadySet()
        self.dps.sync_free_sources(self._free_slot_nodes)
        # step-1 solver state lives for the scheduler's lifetime; dirty
        # components are re-solved per event, the rest are reused
        self._solver = IncrementalAssignmentSolver(
            nodes, strict_parity=self.strict_parity, cap=self._cap_array)
        if self.batched:
            self._kernel = BlockedDrainKernel(
                self._cap_array, self.dps.enable_matrix(self.device), c_node,
                self._inflight_by_task)
        else:
            self._kernel = None

    # ------------------------------------------------------------- events
    def submit(self, task: TaskSpec) -> None:
        self.ready[task.id] = task
        self._seq += 1
        self._submit_seq[task.id] = self._seq
        if task.inputs:
            self.dps.track_task(task.id, task.inputs)
            self._dirty_tasks.add(task.id)
            self._ready_index.add(
                task.id, task.priority, self.dps.prep_count(task.id),
                self.cops_per_task.get(task.id, 0),
                blocked=self.dps.cop_blocked(task.id))
        else:
            self._less_index.add(task.id, task.mem, task.cores, task.priority)
            self._less_stale = True

    def on_task_finished(self, task_id: int, node: int) -> None:
        if not self._known(task_id):
            return                    # unknown/duplicate id: explicit no-op
        self.running.pop(task_id, None)
        t_node = self.nodes[node]
        t_node.free_mem += self._mem_of(task_id)
        t_node.free_cores += self._cores_of(task_id)
        self._finished_specs.pop(task_id, None)
        self._dirty_nodes.add(node)
        if self._cap_array is not None:
            self._cap_array.refresh_from(node, t_node)

    def on_cop_finished(self, plan: CopPlan, ok: bool = True) -> None:
        if plan.id not in self.active_cops:
            return                    # unknown/duplicate plan: explicit no-op
        self.active_cops.pop(plan.id, None)
        cops = max(0, self.cops_per_task.get(plan.task_id, 0) - 1)
        self.cops_per_task[plan.task_id] = cops
        self._ready_index.update_cops(plan.task_id, cops)
        for n in plan.nodes:
            state = self.nodes[n]
            state.active_cops = max(0, state.active_cops - 1)
            if self._cap_array is not None:
                self._cap_array.refresh_from(n, state)
            if state.active_cops < self.c_node:
                self._slot_freed(n)
        self.inflight_targets.discard((plan.task_id, plan.target))
        infl = self._inflight_by_task.get(plan.task_id)
        if infl is not None:
            infl.discard(plan.target)
            if not infl:
                del self._inflight_by_task[plan.task_id]
        if ok:
            self.dps.commit_cop(plan)   # marks consumer tasks dirty in DPS

    def decline(self, task_id: int, node: int, reason: str = "") -> None:
        """Runtime declined an outstanding placement: revert the reservation
        exactly and requeue the task as a fresh submission (core/adapter.py
        decline-requeue contract).  The node is re-marked dirty and the task
        re-enters the dirty sets via :meth:`submit`, so the next
        ``schedule()`` considers it anew -- with ``strict_parity=False`` the
        step-1 solver additionally seeds its B&B incumbent from the
        just-dissolved assignment.  Unknown or mismatched (task, node) pairs
        are explicit no-ops."""
        if self.running.get(task_id) != node:
            return
        del self.running[task_id]
        t = self._finished_specs.pop(task_id)
        state = self.nodes[node]
        state.free_mem += t.mem
        state.free_cores += t.cores
        if self._cap_array is not None:
            self._cap_array.refresh_from(node, state)
        self._dirty_nodes.add(node)
        self.declines += 1
        self.submit(t)

    def forget_task(self, task_id: int) -> None:
        """Instance retirement: drop retained per-task bookkeeping for a
        *completed* task (COP budget counter, any stale submit seq).  Live
        ids -- still queued or running -- and never-seen ids are explicit
        no-ops, per the adapter's unknown-id contract."""
        if task_id in self.ready or task_id in self.running:
            return
        self.cops_per_task.pop(task_id, None)
        self._submit_seq.pop(task_id, None)

    def _known(self, task_id: int) -> bool:
        """Shared unknown-id guard (core/adapter.py): an id is known iff it
        names a currently running (outstanding-or-started) placement."""
        return task_id in self.running

    # CWS-style adapter surface (core/adapter.py): canonical names for the
    # pre-adapter event methods, so WowScheduler itself satisfies the
    # runtime adapter API and a mock RM can drive it standalone.
    def task_started(self, task_id: int, node: int) -> None:  # noqa: ARG002
        """Runtime ack of a placement; resources were reserved at
        ``schedule()`` time, so this is a pure acknowledgement."""
        pass

    def task_finished(self, task_id: int, node: int) -> None:
        self.on_task_finished(task_id, node)

    def cop_finished(self, plan: CopPlan, ok: bool = True) -> None:
        self.on_cop_finished(plan, ok)

    def node_added(self, node: int) -> None:
        self.note_node_added(node)

    def node_removed(self, node: int) -> None:
        self.note_node_removed(node)

    def note_node_added(self, node: int) -> None:
        self.node_order.add(node)       # no-op when the environment owns it
        if self._cap_array is not None:
            # fresh slot at the end: same re-append semantics as NodeOrder
            self._cap_array.add(node, self.nodes[node])
        self._dirty_nodes.add(node)
        self._less_stale = True
        if self.nodes[node].active_cops < self.c_node:
            self._slot_freed(node)

    def note_node_removed(self, node: int) -> None:
        # tasks prepared on the node were dirtied by dps.drop_node already
        self.node_order.discard(node)
        self._slot_busy(node)
        self._capacity.drop(node)
        self._dirty_nodes.discard(node)
        self._less_stale = True

    # free-COP-slot transitions, mirrored into the DPS source-feasibility
    # index so `cop_blocked` answers stay in lockstep with the probe truth
    def _slot_freed(self, node: int) -> None:
        if node not in self._free_slot_nodes:
            self._free_slot_nodes.add(node)
            self.dps.note_source_freed(node)

    def _slot_busy(self, node: int) -> None:
        if node in self._free_slot_nodes:
            self._free_slot_nodes.discard(node)
            self.dps.note_source_busy(node)

    # remember resource shapes of running tasks so finish can free them even
    # after the TaskSpec left the ready map
    def _mem_of(self, task_id: int) -> int:
        t = self._finished_specs.get(task_id)
        return t.mem if t else 0

    def _cores_of(self, task_id: int) -> float:
        t = self._finished_specs.get(task_id)
        return t.cores if t else 0.0

    # ---------------------------------------------------------------- steps
    def schedule(self) -> list[Action]:
        actions: list[Action] = []
        t0 = time.perf_counter()
        started = self._step1_start_prepared(actions)
        t1 = time.perf_counter()
        self._step2_prepare_for_free_compute(actions, started)
        self._step3_speculative_prepare(actions)
        t2 = time.perf_counter()
        self.phase_s["step1_s"] += t1 - t0
        self.phase_s["step23_s"] += t2 - t1
        return actions

    @property
    def solver_stats(self) -> dict:
        """Counters/timings of the incremental step-1 solver (benchmarks)."""
        return self._solver.stats

    def _refresh_candidates(self) -> tuple[set[int], set[int]]:
        """Recompute cached start candidates for exactly the dirty tasks.

        Returns the expanded (dirty tasks, dirty nodes) pair, consumed by
        the incremental solver to decide which components to re-solve."""
        dirty = self._dirty_tasks
        dirty |= self.dps.drain_dirty_tasks()
        dirty_nodes = self._dirty_nodes
        for n in dirty_nodes:
            if n in self.nodes:
                dirty.update(self.dps.iter_tasks_prepared_on(n))
        if dirty_nodes:
            # one batch pass over the dirty nodes (for the array state this
            # is an idempotent re-sync on top of the choke-point writes)
            self._capacity.refresh_many(dirty_nodes)
            self._less_stale = True
        self._dirty_nodes = set()
        self._dirty_tasks = set()
        for tid in dirty:
            t = self.ready.get(tid)
            if t is None or not t.inputs:
                self._startable.pop(tid, None)
                if t is None:
                    self._ready_index.discard(tid)
                continue
            self._ready_index.update_prep(tid, self.dps.prep_count(tid))
            prep = self.dps.prepared_nodes_task(tid)
            cands = [n for n in prep if self.nodes[n].fits(t)]
            if cands:
                self._startable[tid] = cands
            else:
                self._startable.pop(tid, None)
        return dirty, dirty_nodes

    def _inputless_candidates(self) -> dict[int, list[int]]:
        """Candidate lists (all fitting nodes, canonical order) for the
        currently *startable* input-less ready tasks, built per task shape
        from the shape index and the capacity classes -- needed in full
        only on the (rare) mixed event that must be solved jointly."""
        cands: dict[int, list[int]] = {}
        for shape in self._less_index.shapes():
            fit = self._capacity.fitting(*shape)
            if fit:
                for tid in self._less_index.tasks_of(shape):
                    cands[tid] = fit
        return cands

    def _solve_inputless(self) -> dict[int, int]:
        """Capacity-only step-1 assignment for input-less ready tasks,
        O(shapes + assigned) per stale event instead of O(backlog).

        Decision-identical to handing the whole input-less backlog to
        `ilp.solve` (the pre-index path, equivalence-tested): shapes whose
        fitting-node sets overlap are grouped with the same union-find the
        solver's decomposition uses, and every task of a shape carries the
        same candidate list, so shape components expand to exactly the
        task<->node components `ilp.solve` would find.  Each component is
        then answered by the cheapest tier that is provably bit-equal:

        * **uniform fast path** -- a single-shape component past the exact
          gate (``ilp.exact_gate``, the single definition both callers
          share) is what ``solve_greedy`` would see; for identical tasks
          greedy is
          "best-fit place in (-priority, id) order until the first failure"
          (free capacity never grows mid-solve, so every later task of the
          shape fails too) and its repair pass provably no-ops (a skipped
          task can have no strictly-lower-priority placed task when
          placement order is priority-descending and all shapes are equal).
          The shape index stores buckets in that exact order, so this costs
          O(assigned x fitting nodes) -- no backlog scan, no sort.
        * **generic tier** -- small or multi-shape components go through
          `ilp.solve` unchanged, behind a canonical fingerprint cache
          (`ilp.FingerprintCache`, the step-1 solver's machinery) so a
          recurring capacity subproblem is answered without re-searching.
        """
        self.inputless_stats["events"] += 1
        fits: dict[tuple[int, float], list[int]] = {}
        for shape in self._less_index.shapes():
            fit = self._capacity.fitting(*shape)
            if fit:
                fits[shape] = fit
        if not fits:
            return {}
        assign: dict[int, int] = {}
        for comp in group_by_shared_nodes(list(fits), fits.__getitem__):
            if len(comp) == 1:
                shape = comp[0]
                group = self._less_index.group(shape)
                fit = fits[shape]
                if not exact_gate(len(group), len(group) * len(fit)):
                    self.inputless_stats["fast_solves"] += 1
                    if self._cap_array is not None:
                        assign.update(
                            self._greedy_uniform_vec(shape, group, fit))
                    else:
                        assign.update(self._greedy_uniform(shape, group, fit))
                    continue
            n_tasks = sum(len(self._less_index.group(s)) for s in comp)
            n_cand = sum(len(self._less_index.group(s)) * len(fits[s])
                         for s in comp)
            if not exact_gate(n_tasks, n_cand):
                # multi-shape component past the gate: the untruncated solve
                # would be one big `solve_greedy`; the per-shape capacity
                # bound drops tasks that solve provably never places nor
                # repairs around, so the instance is O(capacity)-sized.
                # NB the gate is evaluated on the *untruncated* counts --
                # deciding it on the truncated instance could flip a greedy
                # answer to an exact one and break bit-parity.
                self.inputless_stats["trunc_solves"] += 1
                tids = self._truncate_component(comp, fits)
                cand = {tid: fits[self._less_index.shape_of(tid)]
                        for tid in tids}
                assign.update(self._solve_truncated(tids, cand))
                continue
            tids = sorted(
                (tid for s in comp for tid in self._less_index.tasks_of(s)),
                key=self._submit_seq.__getitem__)
            cand = {tid: fits[self._less_index.shape_of(tid)]
                    for tid in tids}
            assign.update(self._solve_inputless_component(tids, cand))
        return assign

    def _shape_capacity(self, shape: tuple[int, float],
                        fit: list[int]) -> int:
        """Upper bound on how many ``shape`` tasks a greedy pass can place
        simultaneously on ``fit``, from the current free resources.  The
        cores bound adds a +1 float-safety margin per node (repeated float
        subtraction may admit one placement more than ``//`` predicts;
        overcounting only keeps extra tasks, undercounting would break
        parity).  Dict and array paths compute identical values."""
        mem, cores = shape
        if mem <= 0 and cores <= 0:
            return len(fit) * (1 << 40)     # unbounded: keep everything
        cap = self._cap_array
        if cap is not None:
            # float64 `//` is floor division, as numpy's and Python's
            slots = cap.slots_of(fit)
            if mem > 0:
                bound = cap.free_mem[slots] // mem
                if cores > 0:
                    cb = (cap.free_cores[slots] // cores).to(torch.int64) + 1
                    bound = torch.minimum(bound, cb)
            else:
                bound = (cap.free_cores[slots] // cores).to(torch.int64) + 1
            return int(bound.sum())
        total = 0
        for n in fit:
            s = self.nodes[n]
            if mem > 0:
                b = s.free_mem // mem
                if cores > 0:
                    b = min(b, int(s.free_cores // cores) + 1)
            else:
                b = int(s.free_cores // cores) + 1
            total += b
        return total

    def _truncate_component(self, comp: list[tuple[int, float]],
                            fits: dict[tuple[int, float], list[int]],
                            ) -> list[int]:
        """Decision-identical truncation of a large multi-shape input-less
        component (DESIGN.md "Vectorized hot state" / truncation note).

        Keep, per shape, the first ``C_s`` tasks of the ``(-priority, id)``
        bucket (``C_s`` = :meth:`_shape_capacity`), plus every task whose
        priority exceeds ``Q``, the minimum priority over all kept
        prefixes.  A dropped task (beyond its prefix, priority <= Q) is a
        provable no-op for ``solve_greedy`` on the full instance: the
        greedy pass cannot place it (its >= C_s same-shape predecessors
        either exhausted the shape's capacity or one of them already failed
        under monotonically shrinking capacity), and its repair iteration
        only reaches placed tasks of *strictly lower* priority -- none
        exist, because everything placed is kept and every kept task has
        priority >= Q >= the dropped task's.  So the repair pass sees the
        same placed set and performs the same relocations either way."""
        idx = self._less_index
        prefix: dict[tuple[int, float], int] = {}
        q: float | None = None
        for shape in comp:
            group = idx.group(shape)
            k = min(len(group), self._shape_capacity(shape, fits[shape]))
            prefix[shape] = k
            last_prio = -group[k - 1][0]
            if q is None or last_prio < q:
                q = last_prio
        kept: list[int] = []
        for shape in comp:
            group = idx.group(shape)
            k = prefix[shape]
            kept.extend(tid for _, tid in group[:k])
            kept.extend(tid for negp, tid in group[k:] if -negp > q)
        kept.sort(key=self._submit_seq.__getitem__)
        return kept

    def _solve_truncated(self, tids: list[int],
                         cand: dict[int, list[int]]) -> dict[int, int]:
        """Greedy solve of a truncated component, cached like the generic
        tier.  ``solve_greedy`` is forced directly: re-running the tiered
        gate on the (smaller) truncated instance could flip it to the exact
        tier and change decisions.  The fingerprint is salted so these
        greedy answers never collide with tiered answers of an isomorphic
        small component."""
        fp, nlist, npos = component_fingerprint(
            tids, self.ready, cand, self.nodes, cap=self._cap_array)
        fp = ("trunc", fp)
        hit = self._less_cache.get(fp, tids, nlist)
        if hit is not None:
            self.inputless_stats["cache_hits"] += 1
            return hit
        self.inputless_stats["cache_misses"] += 1
        sub = solve_greedy(AssignmentProblem(
            [self.ready[tid] for tid in tids], cand,
            {n: self.nodes[n] for n in nlist}, self._cap_array))
        self._less_cache.put(fp, tids, npos, sub)
        return sub

    def _greedy_uniform(self, shape: tuple[int, float],
                        group: list[tuple[float, int]],
                        fit: list[int]) -> dict[int, int]:
        """Best-fit placement of identical tasks in ``(-priority, id)``
        order, stopping at the first task that fits nowhere -- bit-equal to
        ``solve_greedy`` on the single-shape component (see
        :meth:`_solve_inputless`)."""
        mem, cores = shape
        free_mem = {n: self.nodes[n].free_mem for n in fit}
        free_cores = {n: self.nodes[n].free_cores for n in fit}
        out: dict[int, int] = {}
        for _, tid in group:
            best = None
            best_key = None
            for n in fit:
                fm, fc = free_mem[n], free_cores[n]
                if fm >= mem and fc >= cores:
                    key = (fc - cores, fm - mem, n)
                    if best is None or key < best_key:
                        best, best_key = n, key
            if best is None:
                break
            out[tid] = best
            free_mem[best] -= mem
            free_cores[best] -= cores
        return out

    def _greedy_uniform_vec(self, shape: tuple[int, float],
                            group: list[tuple[float, int]],
                            fit: list[int]) -> dict[int, int]:
        """Array twin of :meth:`_greedy_uniform`: the best-fit key
        ``(fc - cores, fm - mem, id)`` is minimized by three staged masked
        reductions over the same values the dict loop reads (the
        subtractions are performed *before* comparing, so float ties fall
        exactly where the dict path's tuple comparison puts them)."""
        mem, cores = shape
        cap = self._cap_array
        slots = cap.slots_of(fit)
        fm = cap.free_mem[slots]            # gathers: copies
        fc = cap.free_cores[slots]
        ids = torch.tensor(fit, dtype=torch.int64, device=self.device)
        out: dict[int, int] = {}
        for _, tid in group:
            ok = (fm >= mem) & (fc >= cores)
            fck = torch.where(ok, fc - cores, math.inf)
            m0 = fck.min()
            if bool(m0 == math.inf):
                break                       # first failure stops the shape
            t1 = fck == m0
            fmk = torch.where(t1, fm - mem, _BIG)
            t2 = fmk == fmk.min()
            idk = torch.where(t2, ids, _BIG)
            j = int(idk.argmin())
            out[tid] = fit[j]
            fm[j] -= mem
            fc[j] -= cores
        return out

    def _solve_inputless_component(self, tids: list[int],
                                   cand: dict[int, list[int]]) -> dict[int, int]:
        """One small/multi-shape input-less component through the tiered
        stateless solve, answered via the canonical fingerprint cache when
        the subproblem recurred."""
        fp, nlist, npos = component_fingerprint(
            tids, self.ready, cand, self.nodes, cap=self._cap_array)
        hit = self._less_cache.get(fp, tids, nlist)
        if hit is not None:
            self.inputless_stats["cache_hits"] += 1
            return hit
        self.inputless_stats["cache_misses"] += 1
        sub = solve_stateless(AssignmentProblem(
            [self.ready[tid] for tid in tids], cand, self.nodes,
            self._cap_array))
        self._less_cache.put(fp, tids, npos, sub)
        return sub

    # Step 1: assign ready tasks to prepared nodes via the incremental ILP.
    def _step1_start_prepared(self, actions: list[Action]) -> set[int]:
        dirty_tasks, dirty_nodes = self._refresh_candidates()
        stale = len(self._less_index) > 0 and self._less_stale
        less_cands: dict[int, list[int]] = {}
        if stale and self._startable:
            # mixed event: startable input-less and data-bound tasks could
            # compete for the same capacity -- expand the full candidate
            # dict (O(fitting backlog), rare) and solve jointly (the
            # pre-fast-path behaviour) so decisions stay bit-exact.
            t0 = time.perf_counter()
            less_cands = self._inputless_candidates()
            self._less_stale = False
            self.phase_s["inputless_s"] += time.perf_counter() - t0
        if less_cands:
            # joint time is inherently unsplittable and counts as solver
            # time, not inputless_s
            self.inputless_stats["joint_events"] += 1
            assign = self._solver.solve_event(
                self.ready, {**self._startable, **less_cands},
                self._submit_seq, dirty_tasks | set(less_cands), dirty_nodes)
        else:
            # the solver must see every event's dirty sets (even when
            # nothing is currently startable) so its component structure
            # stays in sync
            assign = self._solver.solve_event(
                self.ready, self._startable, self._submit_seq,
                dirty_tasks, dirty_nodes)
            if stale and not self._startable:
                t0 = time.perf_counter()
                extra = self._solve_inputless()
                self._less_stale = False
                self.phase_s["inputless_s"] += time.perf_counter() - t0
                if extra:
                    assign = dict(assign)
                    assign.update(extra)
        started: set[int] = set()
        for tid, n in sorted(assign.items()):
            t = self.ready.pop(tid)
            node = self.nodes[n]
            node.free_mem -= t.mem
            node.free_cores -= t.cores
            if self._cap_array is not None:
                # write through *now*: the step-2/3 pool masks of this same
                # event read post-reservation capacity, like the dict path
                self._cap_array.set_free(n, node.free_mem, node.free_cores)
            self.running[tid] = n
            self._finished_specs[tid] = t
            started.add(tid)
            self.tasks_started += 1
            actions.append(StartTask(tid, n))
            # incremental bookkeeping: the reservation changed n's resources
            self._dirty_nodes.add(n)
            self._startable.pop(tid, None)
            self._submit_seq.pop(tid, None)
            if t.inputs:
                self.dps.untrack_task(tid)
                self._ready_index.discard(tid)
            else:
                self._less_index.discard(tid)
        return started

    def _sync_ready_index(self) -> None:
        """Propagate pending blocked-state flips from the DPS
        source-feasibility index into the step-2/3 orders."""
        for tid in self.dps.drain_blocked_dirty():
            if tid in self._ready_index:
                self._ready_index.set_blocked(tid, self.dps.cop_blocked(tid))

    def _cop_slots_free(self, node_id: int) -> bool:
        return self.nodes[node_id].active_cops < self.c_node

    def _cop_target_pool(self, t: TaskSpec):
        """(feasibility constraint, candidate-target pool) for preparing
        ``t`` under the current free-COP-slot set.  Pool is None when no
        target can be feasible.  Skipping pruned targets cannot change
        decisions: infeasible plan_cop probes are side-effect-free (see
        dps.cop_feasible_targets)."""
        feas = self.dps.cop_feasible_targets(t.inputs, self._free_slot_nodes)
        if feas is None:
            return None, self._free_slot_nodes
        if feas:
            return feas, feas & self._free_slot_nodes
        return feas, None

    def _task_cop_budget(self, task_id: int) -> bool:
        return self.cops_per_task.get(task_id, 0) < self.c_task

    def _start_cop(self, plan: CopPlan, actions: list[Action]) -> None:
        self.active_cops[plan.id] = plan
        cops = self.cops_per_task.get(plan.task_id, 0) + 1
        self.cops_per_task[plan.task_id] = cops
        self._ready_index.update_cops(plan.task_id, cops)
        for n in plan.nodes:
            state = self.nodes[n]
            state.active_cops += 1
            if self._cap_array is not None:
                self._cap_array.refresh_from(n, state)
            if state.active_cops >= self.c_node:
                self._slot_busy(n)
        self.inflight_targets.add((plan.task_id, plan.target))
        self._inflight_by_task.setdefault(plan.task_id, set()).add(plan.target)
        self.cops_created += 1
        actions.append(StartCop(plan))

    # Step 2: prepare unassigned ready tasks on nodes with free *compute*.
    #
    # Both steps iterate a snapshot of the indexed ready order instead of
    # sorting the backlog: the ReadySet maintains exactly the reference's
    # sort keys, and parks tasks whose probes are provably infeasible
    # (dps.cop_blocked), whose skipping is decision-free because failed
    # probes have no side effects.  Mid-loop mutations (COP starts bump the
    # visited task's COP count and may block later tasks) update the
    # structure immediately but not the materialized snapshot -- matching
    # the reference, which sorts once and re-checks budget/feasibility at
    # visit time, as the loops here still do.
    def _step2_prepare_for_free_compute(self, actions: list[Action],
                                        started: set[int]) -> None:
        del started  # step 1 already popped started tasks from self.ready
        if not self._free_slot_nodes:
            return
        self._sync_ready_index()
        dps = self.dps
        kern = self._kernel
        if kern is not None:
            kern.begin()
        for tid in self._ready_index.step2_order():
            if not self._free_slot_nodes:
                break               # no COP can start or source anywhere
            t = self.ready[tid]
            if not self._task_cop_budget(tid):
                continue
            feas, pool = self._cop_target_pool(t)
            if pool is None:
                continue
            if kern is not None and pool is self._free_slot_nodes:
                # blocked kernel (DESIGN.md "Batched COP drain"): the whole
                # candidate mask + cost row + staged argmin as array ops.
                # An unconstrained pool means feas is None, and then the
                # probe on *any* candidate target always succeeds (every
                # input has an admissible free-slot source, and a source
                # that is the target cannot be needed -- the file would not
                # be missing there), so the dict path's probe loop stops at
                # its first, minimum-key candidate: exactly the winner.
                winner = kern.step2_winner(tid, t, dps)
                if winner is None:
                    self.drain_stats["step2_kernel"] += 1
                    continue        # empty candidate set: oracle starts none
                if winner >= 0:
                    plan = dps.plan_cop(tid, t.inputs, winner,
                                        self._free_slot_nodes,
                                        feasible_targets=feas)
                    if plan is not None:
                        self.drain_stats["step2_kernel"] += 1
                        self._start_cop(plan, actions)
                        continue
                # winner == -1 (untracked row) or -- unreachable by the
                # invariant above -- an infeasible winning probe: fall
                # through to the per-task oracle (re-probing the winner is
                # harmless, infeasible probes are side-effect-free)
            self.drain_stats["step2_oracle"] += 1
            self._step2_probe_task(tid, t, feas, pool, actions)

    def _step2_probe_task(self, tid: int, t: TaskSpec, feas, pool,
                          actions: list[Action]) -> None:
        """Per-task step-2 machinery -- the retained dict oracle the blocked
        kernel is property-tested bit-identical against, and the live path
        for constrained pools (``pool is not _free_slot_nodes``), for
        ``batched=False``, and for the kernel's defensive fallthrough."""
        dps = self.dps
        # nodes with free compute capacity, spare COP slot, not already
        # prepared / being prepared
        prepped = dps.prepared_node_set(tid)
        inflight = self.inflight_targets
        if self._cap_array is not None and pool is self._free_slot_nodes:
            # whole free-slot pool: one masked array scan replaces the
            # per-node fits() walk (identical set; the sort below fixes
            # the order either way)
            base = self._cap_array.free_slot_fit_ids(t.mem, t.cores)
        else:
            base = [n for n in pool if self.nodes[n].fits(t)]
        cands = [n for n in base
                 if (tid, n) not in inflight and n not in prepped]
        if not cands:
            return
        # earliest start ~ fewest missing bytes (paper §IV-C).  Most
        # candidates hold none of the task's inputs and share the key
        # (task_bytes, n), so when *no* node holds input bytes the sort
        # degenerates to plain id order -- same result, no key calls.
        # Under a hierarchical topology the metric is locality-weighted
        # missing bytes: a same-rack replica beats a WAN one.
        if dps.topology is not None:
            cost = dps.locality_missing_cost
            cands.sort(key=lambda n: (cost(tid, n), n))
        else:
            present = dps.present_bytes_map(tid)
            if present:
                tb = dps.task_input_bytes(tid)
                get = present.get
                cands.sort(key=lambda n: (tb - get(n, 0), n))
            else:
                cands.sort()
        for n in cands:
            plan = dps.plan_cop(tid, t.inputs, n, self._free_slot_nodes,
                                feasible_targets=feas)
            if plan is not None:
                self._start_cop(plan, actions)
                break

    # Step 3: use leftover network capacity to speculatively prepare
    # high-priority tasks on compute-busy nodes.
    def _step3_speculative_prepare(self, actions: list[Action]) -> None:
        if not self._free_slot_nodes:
            return
        self._sync_ready_index()
        dps = self.dps
        order = self.node_order
        kern = self._kernel
        if kern is not None:
            kern.begin()
        for tid in self._ready_index.step3_order():
            if not self._free_slot_nodes:
                break
            if not self._task_cop_budget(tid):
                continue
            t = self.ready[tid]
            feas, pool = self._cop_target_pool(t)
            if pool is None:
                continue
            # canonical order: the reference probes nodes in enumeration
            # order and plan_cop consumes tie-break randomness per feasible
            # probe, so the probe order is decision-relevant.  The masked
            # scan yields slot order, which *is* canonical order.  Unlike
            # step 2 the probe loop itself cannot be batched: every
            # *feasible* probe consumes a COP id (and possibly a tie-break
            # RNG draw) whether or not it wins, so the blocked kernel only
            # replaces candidate-mask construction.
            cands = None
            if kern is not None and pool is self._free_slot_nodes:
                cands = kern.step3_candidates(tid, t)
            if cands is not None:
                self.drain_stats["step3_kernel"] += 1
            elif self._cap_array is not None and pool is self._free_slot_nodes:
                self.drain_stats["step3_oracle"] += 1
                prepped = dps.prepared_node_set(tid)
                inflight = self.inflight_targets
                cands = [
                    n for n in self._cap_array.free_slot_total_fit_ids(
                        t.mem, t.cores)
                    if (tid, n) not in inflight and n not in prepped]
            else:
                self.drain_stats["step3_oracle"] += 1
                prepped = dps.prepared_node_set(tid)
                inflight = self.inflight_targets
                cands = order.sort(
                    n for n in pool
                    if (tid, n) not in inflight
                    and n not in prepped
                    and t.mem <= self.nodes[n].mem    # could ever run here
                    and t.cores <= self.nodes[n].cores)
            if not cands:
                continue
            best: CopPlan | None = None
            for n in cands:
                plan = dps.plan_cop(tid, t.inputs, n, self._free_slot_nodes,
                                    feasible_targets=feas)
                if plan is not None and (best is None or plan.price < best.price):
                    best = plan
            if best is not None:
                self._start_cop(best, actions)
