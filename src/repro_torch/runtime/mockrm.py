"""Asyncio mock resource manager driving a scheduler adapter live.

This is the "real-ish runtime" half of the CWS-style adapter boundary
(``core/adapter.py``): where ``sim/engine.py`` drives the adapter from a
virtual-time event heap, :class:`MockResourceManager` drives the *same*
scheduler core from a real asyncio event loop, the way Lehmann et al.'s
Common Workflow Scheduler Interface sits between a workflow engine and a
cluster RM (arXiv:2302.07652).  It exercises exactly the traffic a closed
simulator cannot:

* **RM latency** -- every placement decision travels a configurable,
  jittered round trip before the RM acks (``task_started``) or nacks
  (``decline``) it.
* **Placement declines** -- probabilistic (seeded, keyed by
  ``(task, attempt)`` so the decline stream is independent of event
  timing) and capacity-driven (the RM keeps its own ledger with seeded
  external load the scheduler cannot see, and declines placements that
  do not fit it).  Declined tasks re-enter the queue via the adapter's
  decline-requeue contract; a per-task attempt cap bounds retries so a
  permanently loaded node cannot livelock the run.
* **Out-of-order completions** -- task durations vary, so completions do
  not respect start order; the report counts the observed inversions.

All adapter callbacks are applied from the single pump coroutine (launch
coroutines only enqueue events), so the scheduler core never sees
concurrent calls -- same single-threaded discipline as the sim engine.

This is the reference's ``repro/runtime/mockrm.py``, the port's entry point
to the WOW core outside a simulator.  The port adds two things:

* ``run_mock_rm(..., device=...)``: CUDA unless the caller names another;
  an adapter whose WOW core keeps its tensors elsewhere is refused.
* :func:`run_on_virtual_clock` runs ``MockResourceManager(...).run()`` (the
  port's or the reference's) on a virtual clock (:class:`VirtualClockLoop`):
  a sleep ends as soon as every coroutine waits, its delay later on the
  loop's clock.  The order of events is then a function of the seed alone,
  not of how long ``schedule()`` took, so two runs -- on two devices, or of
  the two packages -- give one action stream and one report (``wall_s`` is
  then virtual seconds).  On the real clock (``run_mock_rm``, as in the
  reference) only the counters keyed by (task, attempt) repeat.
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Optional

from ..core.adapter import assert_implements
from ..core.types import FileSpec, StartCop, StartTask, TaskSpec
from ..models.common import require_device, same_device


@dataclasses.dataclass
class MockRMConfig:
    """Knobs for the mock RM.  Times are real seconds (keep them small:
    the smoke tests finish a whole workflow in well under a second)."""

    latency_s: float = 0.002          # RM round-trip before ack/nack
    latency_jitter: float = 0.5       # +- fraction of latency_s, seeded
    decline_prob: float = 0.0         # probabilistic nack per (task, attempt)
    max_attempts: int = 8             # after this many nacks, force-accept
    task_time_s: tuple[float, float] = (0.002, 0.008)  # fallback duration
    cop_time_s: tuple[float, float] = (0.001, 0.004)
    external_load: float = 0.0        # fraction of each node the RM ledger
                                      # considers occupied by foreign work
    seed: int = 0


@dataclasses.dataclass
class RMReport:
    """What happened on the wire, from the RM's point of view."""

    tasks_total: int = 0
    completed: int = 0
    declines: int = 0
    capacity_declines: int = 0
    cops_completed: int = 0
    out_of_order: int = 0             # completions beating an earlier start
    backlog_max: int = 0              # max submitted-but-not-started tasks
    attempts_max: int = 1             # worst per-task placement attempts
    wall_s: float = 0.0


class DeclinePolicy:
    """Seeded decline decisions keyed by ``(task_id, attempt)``.

    Keying by the pair (instead of drawing from a shared stream) makes the
    decline pattern a pure function of the workload, independent of event
    interleaving -- the property the ``run_live_rm`` benchmark and the
    determinism tests rely on.  Attempts at or beyond ``max_attempts`` are
    always accepted, so retries terminate.
    """

    def __init__(self, prob: float, seed: int = 0,
                 max_attempts: int = 8) -> None:
        self.prob = prob
        self.seed = seed
        self.max_attempts = max_attempts

    def declines(self, task_id: int, attempt: int) -> bool:
        if self.prob <= 0.0 or attempt >= self.max_attempts:
            return False
        return random.Random(
            f"{self.seed}:{task_id}:{attempt}").random() < self.prob


class MockResourceManager:
    """Drive any runtime adapter through a workload of tasks and files.

    ``tasks`` maps task id -> :class:`TaskSpec`; ``files`` maps file id ->
    :class:`FileSpec` (producers/consumers define the DAG -- a task is
    submitted once every input file has been produced).  Adapters with a
    DPS (``local_io``) get output files registered on the producing node,
    mirroring the sim engine's data path.
    """

    def __init__(self, adapter, tasks: dict[int, TaskSpec],
                 files: Optional[dict[int, FileSpec]] = None,
                 cfg: Optional[MockRMConfig] = None) -> None:
        assert_implements(adapter)
        self.adapter = adapter
        self.tasks = dict(tasks)
        self.files = dict(files or {})
        self.cfg = cfg or MockRMConfig()
        self.policy = DeclinePolicy(self.cfg.decline_prob, self.cfg.seed,
                                    self.cfg.max_attempts)
        self.report = RMReport(tasks_total=len(self.tasks))
        self._attempts: dict[int, int] = {}
        # the RM's own capacity ledger, with seeded external load the
        # scheduler cannot see (capacity-driven declines)
        rng = random.Random(f"{self.cfg.seed}:ledger")
        self._rm_free: dict[int, tuple[int, float]] = {}
        for n, s in adapter.nodes.items():
            frac = self.cfg.external_load * rng.random()
            self._rm_free[n] = (int(s.mem * (1 - frac)),
                                s.cores * (1 - frac))

    # ------------------------------------------------------------ plumbing
    def _duration(self, t: TaskSpec) -> float:
        if t.compute_time > 0.0:
            return t.compute_time
        lo, hi = self.cfg.task_time_s
        return random.Random(f"{self.cfg.seed}:dur:{t.id}").uniform(lo, hi)

    def _latency(self, key) -> float:
        u = random.Random(f"{self.cfg.seed}:lat:{key}").uniform(
            -self.cfg.latency_jitter, self.cfg.latency_jitter)
        return max(0.0, self.cfg.latency_s * (1.0 + u))

    def _rm_fits(self, t: TaskSpec, node: int) -> bool:
        mem, cores = self._rm_free[node]
        return t.mem <= mem and t.cores <= cores

    def _rm_take(self, t: TaskSpec, node: int) -> None:
        mem, cores = self._rm_free[node]
        self._rm_free[node] = (mem - t.mem, cores - t.cores)

    def _rm_give(self, t: TaskSpec, node: int) -> None:
        mem, cores = self._rm_free[node]
        self._rm_free[node] = (mem + t.mem, cores + t.cores)

    # ------------------------------------------------------------ coroutines
    async def _launch(self, tid: int, node: int) -> None:
        attempt = self._attempts.get(tid, 0)
        self._attempts[tid] = attempt + 1
        self.report.attempts_max = max(self.report.attempts_max, attempt + 1)
        await asyncio.sleep(self._latency(("task", tid, attempt)))
        t = self.tasks[tid]
        if self.policy.declines(tid, attempt):
            await self._events.put(("decline", tid, node, "rm_throttled"))
            return
        if attempt + 1 < self.cfg.max_attempts and not self._rm_fits(t, node):
            await self._events.put(("decline", tid, node, "rm_capacity"))
            return
        self._rm_take(t, node)
        await self._events.put(("started", tid, node))
        await asyncio.sleep(self._duration(t))
        await self._events.put(("finished", tid, node))

    async def _copy(self, plan) -> None:
        lo, hi = self.cfg.cop_time_s
        await asyncio.sleep(
            random.Random(f"{self.cfg.seed}:cop:{plan.id}").uniform(lo, hi))
        await self._events.put(("cop", plan))

    # ------------------------------------------------------------ pump
    def _submit_ready(self) -> None:
        for tid in sorted(self._blocked):
            if all(self._produced.get(f) is not None
                   for f in self.tasks[tid].inputs):
                self._blocked.discard(tid)
                self._queued.add(tid)
                self.adapter.submit(self.tasks[tid])

    def _apply(self, ev) -> None:
        kind = ev[0]
        if kind == "decline":
            _, tid, node, reason = ev
            self.report.declines += 1
            if reason == "rm_capacity":
                self.report.capacity_declines += 1
            self._queued.add(tid)
            self.adapter.decline(tid, node, reason)
        elif kind == "started":
            _, tid, node = ev
            self._start_seq[tid] = len(self._start_seq)
            self.adapter.task_started(tid, node)
        elif kind == "finished":
            _, tid, node = ev
            t = self.tasks[tid]
            self._rm_give(t, node)
            seq = self._start_seq.pop(tid)
            if any(s < seq for s in self._start_seq.values()):
                self.report.out_of_order += 1
            self._inflight -= 1
            self.report.completed += 1
            self.adapter.task_finished(tid, node)
            dps = getattr(self.adapter, "dps", None)
            for f in t.outputs:
                self._produced[f] = node
                if dps is not None and f in self.files:
                    dps.register_file(self.files[f], node)
            self._submit_ready()
        elif kind == "cop":
            _, plan = ev
            self.report.cops_completed += 1
            self._cops_inflight -= 1
            self.adapter.cop_finished(plan, ok=True)

    async def run(self) -> RMReport:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        self._events: asyncio.Queue = asyncio.Queue()
        self._produced: dict[int, Optional[int]] = {}
        self._start_seq: dict[int, int] = {}
        self._blocked = set(self.tasks)
        self._queued: set[int] = set()
        self._inflight = 0
        self._cops_inflight = 0
        self._pending: set[asyncio.Task] = set()
        self._submit_ready()
        while self.report.completed < len(self.tasks):
            for act in self.adapter.schedule():
                if isinstance(act, StartTask):
                    self._queued.discard(act.task_id)
                    self._inflight += 1
                    co = loop.create_task(self._launch(act.task_id, act.node))
                elif isinstance(act, StartCop):
                    self._cops_inflight += 1
                    co = loop.create_task(self._copy(act.plan))
                else:      # pragma: no cover - unknown action type
                    continue
                self._pending.add(co)
                co.add_done_callback(self._pending.discard)
            self.report.backlog_max = max(self.report.backlog_max,
                                          len(self._queued))
            if (self._inflight == 0 and self._cops_inflight == 0
                    and self._events.empty()):
                raise RuntimeError(
                    f"mock RM stalled: {self.report.completed}/"
                    f"{len(self.tasks)} done, {len(self._queued)} queued, "
                    f"{len(self._blocked)} blocked")
            self._apply(await self._events.get())
            while not self._events.empty():
                self._apply(self._events.get_nowait())
        for co in self._pending:
            co.cancel()
        self.report.wall_s = loop.time() - t0
        return self.report


class _VirtualSelector:
    """A selector that never blocks: with no file event ready it moves its
    loop's clock on by the timeout the loop asked to wait."""

    def __init__(self, loop: "VirtualClockLoop", selector) -> None:
        self._loop = loop
        self._sel = selector

    def select(self, timeout=None):
        events = self._sel.select(0)
        if events:
            return events
        if timeout is None:
            # nothing ready and nothing scheduled: on a real clock this
            # would wait forever for an outside event that cannot come
            raise RuntimeError("virtual clock: every coroutine waits and "
                               "no timer is set")
        self._loop._now += timeout
        return events

    def __getattr__(self, name):
        return getattr(self._sel, name)


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop on a virtual clock that starts at 0.0 and moves only
    when every coroutine waits, to the next timer.  Timers fire in the
    order of their deadlines, as on the real clock, however long the code
    between them takes."""

    def __init__(self) -> None:
        import selectors
        self._now = 0.0
        super().__init__(_VirtualSelector(self, selectors.DefaultSelector()))

    def time(self) -> float:
        return self._now


def run_on_virtual_clock(coro):
    """Run ``coro`` to its end on a fresh :class:`VirtualClockLoop`; tasks
    it leaves behind are cancelled and awaited, and the loop is closed."""
    loop = VirtualClockLoop()
    try:
        return loop.run_until_complete(coro)
    finally:
        left = asyncio.all_tasks(loop)
        for t in left:
            t.cancel()
        if left:
            loop.run_until_complete(asyncio.gather(*left,
                                                   return_exceptions=True))
        loop.run_until_complete(loop.shutdown_asyncgens())
        loop.close()


def run_mock_rm(adapter, tasks: dict[int, TaskSpec],
                files: Optional[dict[int, FileSpec]] = None,
                cfg: Optional[MockRMConfig] = None, *,
                device="cuda") -> RMReport:
    """Synchronous wrapper: drive ``adapter`` through the workload on a
    fresh event loop and return the :class:`RMReport`.  ``device`` (CUDA
    unless the caller names another) must be the one the adapter's WOW core
    keeps its tensors on; the baselines keep none."""
    device = require_device(device)
    held = getattr(adapter, "device", None)
    if held is not None and not same_device(held, device):
        raise ValueError(f"the adapter keeps its state on {held}; "
                         f"run_mock_rm was asked for {device}")
    return asyncio.run(MockResourceManager(adapter, tasks, files, cfg).run())
