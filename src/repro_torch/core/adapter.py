"""CWS-style runtime adapter boundary (Lehmann et al., arXiv:2302.07652).

The Common Workflow Scheduler Interface proposal argues that a workflow
scheduler should talk to a resource manager through a small asynchronous
protocol instead of being welded to one engine's event loop.  This module
defines that boundary for this repo: every scheduling policy -- the paper's
WOW scheduler and both baselines -- implements one interface, and both the
closed simulator (``sim/engine.py``) and the live asyncio mock resource
manager (``runtime/mockrm.py``) drive it through the same eight calls.

Protocol (see :class:`RuntimeAdapter`):

* ``submit(task)``            -- a ready task enters the scheduler's queue.
* ``schedule() -> [Action]``  -- placement decisions out (``StartTask`` /
  ``StartCop``).  Resources are *reserved* at decision time; a decision is
  "outstanding" until the runtime acknowledges it.
* ``task_started(task, node)``  -- runtime ack: the placement was accepted.
* ``decline(task, node, reason)`` -- runtime nack: the placement was
  refused (RM throttling, capacity race, admission policy).
* ``task_finished(task, node)`` / ``cop_finished(plan, ok)`` -- completion
  callbacks.
* ``node_added(node)`` / ``node_removed(node)`` -- cluster membership.
* ``forget_task(task)``       -- retire a completed task's retained state.

Decline-requeue contract
------------------------
``decline(t, n)`` must name an outstanding placement previously emitted by
``schedule()``.  The adapter reverts the reservation exactly (free memory
and cores on ``n`` return to their pre-decision values) and requeues ``t``
as a *fresh submission*: the next ``schedule()`` call considers it anew, so
its next placement equals the decision a freshly built scheduler would make
from the same visible state (bit-identity property-tested in
``tests/test_adapter.py``).  Nothing else may observe the aborted decision:
no COP may have been committed against it (``WowScheduler`` plans COPs only
for queued tasks, never started ones), and counters other than ``declines``
are unaffected.

Out-of-order completion contract
--------------------------------
The runtime may deliver ``task_started`` / ``task_finished`` /
``cop_finished`` in any order relative to other tasks: completions need not
respect start order, and a COP result may arrive before or after the
consuming task's own callbacks.  Correctness relies only on per-task
ordering (``schedule`` decision -> ``task_started`` or ``decline`` ->
``task_finished``), which any sane runtime preserves per task.

Unknown-id contract (shared ``_known`` guard)
---------------------------------------------
Callbacks naming an id the adapter does not currently track -- a duplicate
completion, a decline for a task that already finished, ``forget_task`` for
a never-seen id -- are *explicit no-ops*: the adapter returns without
mutating any state.  This is implemented once via :meth:`RuntimeAdapter.
_known` rather than per-strategy ``try/except`` so the guard is part of the
protocol, not an accident of implementation.

The legacy sim-facing names (``iterate`` / ``on_task_finished`` / ...) are
kept as thin forwarders so pre-adapter call sites keep working.

This is the reference's ``repro/core/adapter.py``.  ``WowAdapter`` and
``make_adapter`` take a ``device`` (CUDA unless the caller names another):
the one the WOW core keeps its tensors on.  The baselines hold no tensor
state, but ``make_adapter`` checks the device for them too, so that every
entry point refuses a missing card alike.
"""
from __future__ import annotations

from ..models.common import require_device
from .dps import DataPlacementService
from .readyset import NodeOrder
from .reference import ReferenceWowScheduler
from .scheduler import WowScheduler
from .types import Action, NodeState, StartTask, TaskSpec

#: The eight adapter entry points plus the submit->decisions pair.  Used by
#: conformance tests and by runtimes that duck-type-check their scheduler.
ADAPTER_API: tuple[str, ...] = (
    "submit", "schedule", "decline", "task_started", "task_finished",
    "cop_finished", "node_added", "node_removed", "forget_task",
)


def assert_implements(obj) -> None:
    """Raise ``TypeError`` unless ``obj`` exposes the full adapter API."""
    missing = [m for m in ADAPTER_API if not callable(getattr(obj, m, None))]
    if missing:
        raise TypeError(
            f"{type(obj).__name__} does not implement the runtime adapter "
            f"API: missing {missing}")


class RuntimeAdapter:
    """Base adapter: shared reservation bookkeeping + protocol defaults.

    ``running`` maps task id -> reserved :class:`TaskSpec` for every
    outstanding-or-started placement; the ``_known`` guard keys off it so
    unknown-id callbacks are no-ops (see module docstring for the full
    decline / out-of-order / unknown-id contracts).
    """

    name = "base"
    local_io = False      # True => intermediate I/O on node-local disks

    def __init__(self, nodes: dict[int, NodeState]) -> None:
        self.nodes = nodes
        self.running: dict[int, TaskSpec] = {}
        self.declines = 0

    # ------------------------------------------------------------ protocol
    def submit(self, task: TaskSpec) -> None:
        raise NotImplementedError

    def schedule(self) -> list[Action]:
        raise NotImplementedError

    def task_started(self, task_id: int, node: int) -> None:  # noqa: ARG002
        """Runtime ack of a placement decision.  Pure acknowledgement:
        resources were already reserved at ``schedule()`` time, so the
        default is a no-op (which also keeps the sim engine bit-identical
        to its pre-adapter behaviour)."""
        pass

    def decline(self, task_id: int, node: int, reason: str = "") -> None:
        """Revert an outstanding placement and requeue the task fresh."""
        if not self._known(task_id):
            return
        t = self.running.pop(task_id)
        self.nodes[node].free_mem += t.mem
        self.nodes[node].free_cores += t.cores
        self.declines += 1
        self.submit(t)

    def task_finished(self, task_id: int, node: int) -> None:
        if not self._known(task_id):
            return
        t = self.running.pop(task_id)
        self.nodes[node].free_mem += t.mem
        self.nodes[node].free_cores += t.cores

    def cop_finished(self, plan, ok: bool = True) -> None:  # noqa: ARG002
        """DFS-bound baselines never emit COPs: any plan id is unknown by
        definition, hence the explicit no-op default."""
        pass

    def node_added(self, node: int) -> None:  # noqa: ARG002
        pass

    def node_removed(self, node: int) -> None:  # noqa: ARG002
        pass

    def forget_task(self, task_id: int) -> None:
        """Instance retirement (open-loop traffic): drop any retained spec
        for a completed task so service-mode memory stays bounded.  Ids
        still live (queued or running) or never seen are no-ops."""
        pass

    def churn_probe(self) -> dict:
        """Cheap snapshot of scheduler-internal churn counters, sampled by
        the engine after each traffic arrival (dirty-set / solver-activity
        profiling).  DFS-bound baselines have no incremental core: empty."""
        return {}

    # ------------------------------------------------------------ helpers
    def _known(self, task_id: int) -> bool:
        """Shared unknown-id guard: does ``task_id`` name an outstanding or
        running placement this adapter is tracking?"""
        return task_id in self.running

    def _reserve(self, t: TaskSpec, node: int) -> None:
        self.nodes[node].free_mem -= t.mem
        self.nodes[node].free_cores -= t.cores
        self.running[t.id] = t

    # ------------------------------------- legacy sim-facing names (shim)
    def iterate(self) -> list[Action]:
        return self.schedule()

    def on_task_finished(self, task_id: int, node: int) -> None:
        self.task_finished(task_id, node)

    def on_cop_finished(self, plan, ok: bool = True) -> None:
        self.cop_finished(plan, ok)

    def on_node_added(self, node: int) -> None:
        self.node_added(node)

    def on_node_removed(self, node: int) -> None:
        self.node_removed(node)


class OrigAdapter(RuntimeAdapter):
    """Nextflow original: FIFO task order, round-robin node choice, all
    data exchanged through the DFS."""

    name = "orig"

    def __init__(self, nodes: dict[int, NodeState]) -> None:
        super().__init__(nodes)
        self.queue: list[TaskSpec] = []
        self._rr = 0
        self._node_ids = sorted(nodes)

    def node_added(self, node: int) -> None:
        if node not in self._node_ids:
            self._node_ids.append(node)   # joins the round-robin ring last

    def node_removed(self, node: int) -> None:
        if node in self._node_ids:
            idx = self._node_ids.index(node)
            self._node_ids.pop(idx)
            # keep the round-robin pointer on the same successor node
            if idx < self._rr:
                self._rr -= 1
            if self._node_ids:
                self._rr %= len(self._node_ids)
            else:
                self._rr = 0

    def submit(self, task: TaskSpec) -> None:
        self.queue.append(task)

    def schedule(self) -> list[Action]:
        actions: list[Action] = []
        # strict FIFO: head-of-line blocks when no node fits it
        while self.queue:
            t = self.queue[0]
            placed = False
            for i in range(len(self._node_ids)):
                n = self._node_ids[(self._rr + i) % len(self._node_ids)]
                if self.nodes[n].fits(t):
                    self._rr = (self._rr + i + 1) % len(self._node_ids)
                    self.queue.pop(0)
                    self._reserve(t, n)
                    actions.append(StartTask(t.id, n))
                    placed = True
                    break
            if not placed:
                break
        return actions


class CwsAdapter(RuntimeAdapter):
    """Common Workflow Scheduler baseline: priority (rank, input size)
    order, most-free-cores node; DFS I/O."""

    name = "cws"

    def __init__(self, nodes: dict[int, NodeState]) -> None:
        super().__init__(nodes)
        self.queue: dict[int, TaskSpec] = {}

    def submit(self, task: TaskSpec) -> None:
        self.queue[task.id] = task

    def schedule(self) -> list[Action]:
        actions: list[Action] = []
        for t in sorted(self.queue.values(), key=lambda t: (-t.priority, t.id)):
            cands = [n for n, s in self.nodes.items() if s.fits(t)]
            if not cands:
                continue
            n = max(cands, key=lambda n: (self.nodes[n].free_cores,
                                          self.nodes[n].free_mem, -n))
            del self.queue[t.id]
            self._reserve(t, n)
            actions.append(StartTask(t.id, n))
        return actions


class WowAdapter(RuntimeAdapter):
    """The paper's three-step scheduler + DPS; local intermediate I/O.

    Thin shell: reservation bookkeeping, the decline path and the unknown-id
    guard all live inside :class:`~.scheduler.WowScheduler`, which
    itself implements the adapter API (the shell exists to own the DPS and
    to present the same constructor surface as the baselines)."""

    name = "wow"
    local_io = True

    def __init__(self, nodes: dict[int, NodeState], c_node: int = 1,
                 c_task: int = 2, seed: int = 0,
                 reference_core: bool = False,
                 node_order: NodeOrder | None = None,
                 vectorized: bool = True,
                 strict_parity: bool = True,
                 topology=None,
                 batched: bool | None = None,
                 device="cuda") -> None:
        super().__init__(nodes)
        if node_order is None:
            node_order = NodeOrder(nodes)
        self.device = require_device(device)
        self.dps = DataPlacementService(seed=seed, node_order=node_order)
        if topology is not None:
            # locality-aware COP sources + weighted cost model; a flat
            # topology detaches inside set_topology (bit-identical runs)
            self.dps.set_topology(topology)
        if reference_core:
            # the frozen reference has no vectorized path (and no decline
            # support) by design
            self.sched = ReferenceWowScheduler(
                nodes, self.dps, c_node=c_node, c_task=c_task,
                node_order=node_order)
        else:
            self.sched = WowScheduler(
                nodes, self.dps, c_node=c_node, c_task=c_task,
                node_order=node_order, vectorized=vectorized,
                strict_parity=strict_parity, batched=batched,
                device=self.device)
        self._specs: dict[int, TaskSpec] = {}

    @property
    def declines(self) -> int:
        return getattr(self.sched, "declines", 0)

    @declines.setter
    def declines(self, value: int) -> None:
        # base __init__ zeroes the counter; the core owns the real one
        pass

    def submit(self, task: TaskSpec) -> None:
        self._specs[task.id] = task
        self.sched.submit(task)

    def schedule(self) -> list[Action]:
        return self.sched.schedule()

    def decline(self, task_id: int, node: int, reason: str = "") -> None:
        self.sched.decline(task_id, node, reason)

    def task_finished(self, task_id: int, node: int) -> None:
        # resource bookkeeping lives inside WowScheduler
        self.sched.on_task_finished(task_id, node)

    def cop_finished(self, plan, ok: bool = True) -> None:
        self.sched.on_cop_finished(plan, ok)

    def node_added(self, node: int) -> None:
        self.sched.note_node_added(node)

    def node_removed(self, node: int) -> None:
        self.sched.note_node_removed(node)

    def forget_task(self, task_id: int) -> None:
        self._specs.pop(task_id, None)
        forget = getattr(self.sched, "forget_task", None)
        if forget is not None:
            forget(task_id)

    def _known(self, task_id: int) -> bool:
        return task_id in self.sched.running

    def churn_probe(self) -> dict:
        """Dirty-set sizes + cumulative solver event counter.  The
        reference core keeps no dirty sets or solver stats
        (getattr-guarded).  Counters only -- no wall-clock timings, so the
        probe is replay-deterministic (bit-identical TrafficResults)."""
        probe = {
            "dirty_tasks": (
                len(getattr(self.sched, "_dirty_tasks", ()))
                + len(self.dps._dirty_tasks)),
        }
        stats = getattr(self.sched, "solver_stats", None)
        if stats:
            probe["solver_events"] = stats.get("events", 0)
        return probe


def make_adapter(name: str, nodes: dict[int, NodeState], *, c_node: int = 1,
                 c_task: int = 2, seed: int = 0,
                 reference_core: bool = False,
                 node_order: NodeOrder | None = None,
                 vectorized: bool = True,
                 strict_parity: bool = True,
                 topology=None,
                 batched: bool | None = None,
                 device="cuda") -> RuntimeAdapter:
    device = require_device(device)
    if name == "orig":
        return OrigAdapter(nodes)
    if name == "cws":
        return CwsAdapter(nodes)
    if name == "wow":
        return WowAdapter(nodes, c_node=c_node, c_task=c_task, seed=seed,
                          reference_core=reference_core,
                          node_order=node_order, vectorized=vectorized,
                          strict_parity=strict_parity, topology=topology,
                          batched=batched, device=device)
    raise ValueError(f"unknown strategy {name!r}")
