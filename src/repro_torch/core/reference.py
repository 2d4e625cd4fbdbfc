"""Pre-refactor WOW scheduler, retained as the behavioural reference: the
reference's ``repro/core/reference.py``, copied as it is (it holds no
tensor state, so it takes no device).

This is the original "recompute the world per event" implementation of the
three-step scheduler (paper §III-B): every ``schedule()`` call rescans all
ready tasks x all nodes, recomputes prepared-node sets via replica-set
intersection and rebuilds the COP-slot sets from scratch.  Per-event cost is
O(|ready| * |nodes|), which is exactly why `scheduler.WowScheduler` replaced
it with dirty-set bookkeeping -- but the *decisions* of the two must be
identical, and the equivalence tests (tests/test_incremental.py) prove it by
running both against the same workloads.

Do not "fix" or optimise this module; it is frozen on purpose.  (It is
frozen at the *decision logic* level: it shares the live DPS/ILP
infrastructure, so shared-layer changes -- e.g. `plan_cop` no longer
consuming tie-break randomness on infeasible probes -- can shift absolute
traces versus runs recorded under older versions, while new-vs-reference
equivalence within a version is what the tests guarantee.)
"""
from __future__ import annotations

from .dps import DataPlacementService
# `solve` was renamed when core/ilp.py grew the decomposed/incremental
# tiers; `solve_monolithic` is the identical pre-refactor implementation,
# so this module's behaviour is unchanged.
from .ilp import AssignmentProblem, solve_monolithic as solve
from .types import (Action, CopPlan, NodeState, StartCop, StartTask, TaskSpec)


class ReferenceWowScheduler:
    def __init__(
        self,
        nodes: dict[int, NodeState],
        dps: DataPlacementService,
        c_node: int = 1,
        c_task: int = 2,
        node_order=None,
    ) -> None:
        self.nodes = nodes
        self.dps = dps
        self.c_node = c_node
        self.c_task = c_task
        # constructor-compat with WowScheduler: the canonical node order is
        # *defined* as this scheduler's enumeration order (`list(self.nodes)`
        # below), so the threaded object carries no extra information here
        self.node_order = node_order

        self.ready: dict[int, TaskSpec] = {}
        self.running: dict[int, int] = {}          # task id -> node
        self.active_cops: dict[int, CopPlan] = {}
        self.cops_per_task: dict[int, int] = {}
        self.inflight_targets: set[tuple[int, int]] = set()  # (task, node)
        self._finished_specs: dict[int, TaskSpec] = {}
        # metrics hooks
        self.cops_created: int = 0
        self.tasks_started: int = 0

    # ------------------------------------------------------------- events
    def submit(self, task: TaskSpec) -> None:
        self.ready[task.id] = task

    def on_task_finished(self, task_id: int, node: int) -> None:
        self.running.pop(task_id, None)
        t_node = self.nodes[node]
        t_node.free_mem += self._mem_of(task_id)
        t_node.free_cores += self._cores_of(task_id)
        self._finished_specs.pop(task_id, None)

    def on_cop_finished(self, plan: CopPlan, ok: bool = True) -> None:
        self.active_cops.pop(plan.id, None)
        self.cops_per_task[plan.task_id] = max(
            0, self.cops_per_task.get(plan.task_id, 0) - 1)
        for n in plan.nodes:
            self.nodes[n].active_cops = max(0, self.nodes[n].active_cops - 1)
        self.inflight_targets.discard((plan.task_id, plan.target))
        if ok:
            self.dps.commit_cop(plan)

    def note_node_added(self, node: int) -> None:  # noqa: ARG002
        pass      # stateless w.r.t. the node set; rescans every call

    def note_node_removed(self, node: int) -> None:  # noqa: ARG002
        pass

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
        started = self._step1_start_prepared(actions)
        self._step2_prepare_for_free_compute(actions, started)
        self._step3_speculative_prepare(actions)
        return actions

    # Step 1: assign ready tasks to prepared nodes via the ILP.
    def _step1_start_prepared(self, actions: list[Action]) -> set[int]:
        node_ids = list(self.nodes)
        candidates: dict[int, list[int]] = {}
        tasks: list[TaskSpec] = []
        for t in self.ready.values():
            prep = self.dps.prepared_nodes_reference(t.inputs, node_ids)
            prep = [n for n in prep if self.nodes[n].fits(t)]
            if prep:
                tasks.append(t)
                candidates[t.id] = prep
        if not tasks:
            return set()
        assign = solve(AssignmentProblem(tasks, candidates, self.nodes))
        started: set[int] = set()
        for tid, n in sorted(assign.items()):
            t = self.ready.pop(tid)
            node = self.nodes[n]
            node.free_mem -= t.mem
            node.free_cores -= t.cores
            self.running[tid] = n
            self._finished_specs[tid] = t
            started.add(tid)
            self.tasks_started += 1
            actions.append(StartTask(tid, n))
        return started

    def _cop_slots_free(self, node_id: int) -> bool:
        return self.nodes[node_id].active_cops < self.c_node

    def _task_cop_budget(self, task_id: int) -> bool:
        return self.cops_per_task.get(task_id, 0) < self.c_task

    def _start_cop(self, plan: CopPlan, actions: list[Action]) -> None:
        self.active_cops[plan.id] = plan
        self.cops_per_task[plan.task_id] = (
            self.cops_per_task.get(plan.task_id, 0) + 1)
        for n in plan.nodes:
            self.nodes[n].active_cops += 1
        self.inflight_targets.add((plan.task_id, plan.target))
        self.cops_created += 1
        actions.append(StartCop(plan))

    # Step 2: prepare unassigned ready tasks on nodes with free *compute*.
    def _step2_prepare_for_free_compute(self, actions: list[Action],
                                        started: set[int]) -> None:
        node_ids = list(self.nodes)
        waiting = [t for t in self.ready.values() if t.id not in started
                   and t.inputs]
        if not waiting:
            return
        # ascending |N_prep|, ties by number of running COPs for the task
        def key(t: TaskSpec) -> tuple:
            return (len(self.dps.prepared_nodes_reference(t.inputs, node_ids)),
                    self.cops_per_task.get(t.id, 0), -t.priority, t.id)

        for t in sorted(waiting, key=key):
            if not self._task_cop_budget(t.id):
                continue
            allowed_src = {n for n in node_ids if self._cop_slots_free(n)}
            # nodes with free compute capacity, spare COP slot, not already
            # prepared / being prepared
            cands = [
                n for n in node_ids
                if self.nodes[n].fits(t)
                and self._cop_slots_free(n)
                and (t.id, n) not in self.inflight_targets
                and not self.dps.is_prepared_reference(t.inputs, n)
            ]
            if not cands:
                continue
            # earliest start ~ fewest missing bytes (paper §IV-C); under a
            # hierarchical topology, locality-weighted missing bytes.  The
            # reference form returns the plain byte count as a float when no
            # topology is attached, so the flat-mode sort order (and hence
            # the action stream) is unchanged.
            cands.sort(key=lambda n: (
                self.dps.locality_missing_cost_reference(t.inputs, n), n))
            for n in cands:
                plan = self.dps.plan_cop(t.id, t.inputs, n, allowed_src)
                if plan is not None:
                    self._start_cop(plan, actions)
                    break

    # Step 3: use leftover network capacity to speculatively prepare
    # high-priority tasks on compute-busy nodes.
    def _step3_speculative_prepare(self, actions: list[Action]) -> None:
        node_ids = list(self.nodes)
        todo = [t for t in self.ready.values()
                if t.inputs and self._task_cop_budget(t.id)]
        for t in sorted(todo, key=lambda t: (-t.priority, t.id)):
            allowed_src = {n for n in node_ids if self._cop_slots_free(n)}
            cands = [
                n for n in node_ids
                if self._cop_slots_free(n)
                and (t.id, n) not in self.inflight_targets
                and not self.dps.is_prepared_reference(t.inputs, n)
                and t.mem <= self.nodes[n].mem        # could ever run here
                and t.cores <= self.nodes[n].cores
            ]
            if not cands:
                continue
            best: CopPlan | None = None
            for n in cands:
                plan = self.dps.plan_cop(t.id, t.inputs, n, allowed_src)
                if plan is not None and (best is None or plan.price < best.price):
                    best = plan
            if best is not None:
                self._start_cop(best, actions)
