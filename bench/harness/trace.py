"""The traced run: ``torch.profiler`` over part of the measured window, and
what the per-layer readers take from it.

The harness marks its own calls into the program with ``record_function``
ranges named ``bench:<what>`` (``label``); a kernel belongs to every range
and operation above its launch in the profiler's correlation of launches
to host ranges, whatever its name.  ``Summary`` keeps, for each kernel, the
names of those ranges, so a reader asks for the device time of kernels
launched under a range (``under``), and the window's busy time, its top
device operations and its longest idle gaps named by what the host was
doing."""
from __future__ import annotations

import time
from collections import defaultdict

import torch

PREFIX = "bench:"


def label(name: str):
    """A host range ``bench:<name>`` in the trace (nothing outside one)."""
    return torch.profiler.record_function(PREFIX + name)


class Tracer:
    """The profiler over one traced stretch of the window; ``summary()``
    reads it once it is stopped."""

    def __init__(self, sync) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync = sync
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._range = None
        self.on = False
        # t0, t1: the traced stretch; span: it with the profiler's own
        # start and stop, which the host-clock readings leave out too
        self.t0 = self.t1 = None
        self.span = (None, None)

    def start(self) -> None:
        self._sync()
        self.span = (time.perf_counter(), None)
        self._prof.__enter__()
        self._range = label("trace")
        self._range.__enter__()
        self.t0 = time.perf_counter()
        self.on = True

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.span = (self.span[0], time.perf_counter())
        self.on = False

    def summary(self) -> "Summary":
        return Summary(self._prof.events(), self.t1 - self.t0)


def _union(intervals):
    """Merged (start, end) of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Summary:
    """What the readers take from a trace: ``window_s`` (host clock of the
    traced stretch), ``busy_s`` (the union of device operations' time in
    it), ``device_ops`` and ``idle_gaps`` (each the top 10, [name,
    seconds]), and the device seconds of kernels by the host ranges above
    them (``under``, ``kernels``)."""

    def __init__(self, events, window_s: float) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        # a host range (``record_function``) is mirrored on the device as
        # an annotation spanning its kernels: not an operation of its own
        ranges = {e.name for e in events
                  if getattr(e, "is_user_annotation", False)
                  or e.name.startswith(PREFIX)}
        dev = [e for e in events if e.device_type == cuda
               and e.name not in ranges]
        # each host range's span on the device timeline, from its first
        # kernel to its last
        self.spans = defaultdict(list)
        for e in events:
            if e.device_type == cuda and e.name in ranges:
                self.spans[e.name].append((e.time_range.start,
                                           e.time_range.end))
        self._dev = sorted((e.time_range.start, e.time_range.end)
                           for e in dev)
        cpu = [e for e in events if e.device_type != cuda]
        self.window_s = window_s
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        merged = _union(spans)
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.device_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
        by_name: dict = defaultdict(float)
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
        self.device_ops = [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        # each kernel under the names of the host ranges above its launch
        self.kernels = []
        for e in cpu:
            if not e.kernels:
                continue
            names, up = [], e
            while up is not None:
                names.append(up.name)
                up = up.cpu_parent
            secs = sum(k.duration for k in e.kernels
                       if k.name not in ranges) / 1e6
            self.kernels.append((tuple(names), secs))
        self.attributed_s = sum(s for _, s in self.kernels)
        self.idle_gaps = self._gaps(merged, cpu)

    def _gaps(self, merged, cpu):
        """The 10 longest stretches of the traced range with no device
        operation, each named by the innermost ``bench:`` range and the
        innermost host operation of the harness's thread at its start."""
        trace = [e for e in cpu if e.name == PREFIX + "trace"]
        if not trace:
            return []
        lo, hi = trace[0].time_range.start, trace[0].time_range.end
        thread = trace[0].thread
        gaps, prev = [], lo
        for s, e in merged:
            if s > prev:
                gaps.append((prev, min(s, hi)))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        mine = [e for e in cpu if e.thread == thread and e.name !=
                PREFIX + "trace"]
        out = []
        for s, e in gaps:
            around = [x for x in mine
                      if x.time_range.start <= s < x.time_range.end]
            bench = [x for x in around if x.name.startswith(PREFIX)]
            ops = [x for x in around if not x.name.startswith(PREFIX)]
            name = " / ".join(
                min(xs, key=lambda x: x.time_range.elapsed_us()).name
                for xs in (bench, ops) if xs) or "outside the harness's calls"
            out.append([name, (e - s) / 1e6])
        return out

    @staticmethod
    def _hit(chain, names) -> bool:
        """Whether a host range or operation of ``chain`` is one of
        ``names``: a ``bench:`` range or an operation by its full name, an
        autograd node by its name (``...evaluate_function: <node>``)."""
        return any(n == w or n.endswith(": " + w) for n in chain
                   for w in names)

    def under(self, *names) -> float:
        """Device seconds of kernels launched under one of ``names``."""
        return sum(s for chain, s in self.kernels if self._hit(chain, names))

    def within(self, name: str) -> float:
        """Device seconds of the operations that ran inside the device
        spans of the host range ``name``: for a range whose call launches
        everything the device runs meanwhile (the optimizer's update on
        the one stream, after the backward), its kernels, each counted
        once."""
        total = 0.0
        for lo, hi in _union(self.spans.get(name, ())):
            total += sum(min(e, hi) - max(s, lo) for s, e in self._dev
                         if s < hi and e > lo)
        return total / 1e6

    def not_under(self, *names) -> float:
        """Device seconds of kernels launched under none of ``names``,
        with the device time the profiler linked to no host range."""
        kept = sum(s for chain, s in self.kernels
                   if not self._hit(chain, names))
        return kept + max(self.device_s - self.attributed_s, 0.0)


