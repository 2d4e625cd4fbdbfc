"""Spans and counters inside the port, kept in memory while a recorder is on.

    rec = telemetry.start()
    ...                          # train steps, engine steps
    telemetry.stop()
    for s in rec.spans:          # in the order they opened (a gc at its end)
        s.name, s.id, s.parent, s.start, s.end, s.attrs, s.device_ms

Spans are opened at the layer boundaries of the training step
(``launch/steps.py``, ``runtime/trainer.py``: forward, backward, the
optimizer's update) and of the serving engine (``runtime/serving.py``),
with counts and request ids as attributes.  A span's start and end are
``time.perf_counter()`` readings; its parent is the innermost span open in
its thread when it opened.  A span
given a CUDA ``device`` also records a ``torch.cuda.Event`` pair on that
device's current stream, resolved into ``device_ms`` only when read (after
the caller's own synchronize: a span never adds one).  A span given a CUDA
``allocator`` adds the caching allocator's device mallocs and frees over it
(``mallocs``) and its retries (``alloc_retries``) to its attributes.  While
``torch.profiler`` runs, every span also opens a ``record_function`` range
of its name, so the program's spans lie in the profiler's trace with each
kernel under the span that launched it.  Each garbage collection while
recording is a ``gc`` span (``generation``, ``collected``) under the
innermost span open in the collecting thread.

When no recorder is active a span costs one check of ``active`` and returns
one shared context that does nothing: no clock, no event, no range, no
allocator statistics.  Recording changes no output of the program.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time

import torch

# the module's own references, so that a test can show the off path
# calls neither
_clock = time.perf_counter
_record_function = torch.profiler.record_function

# the recorder spans are kept by, or None (set by ``start`` and ``stop``)
active: "Recorder | None" = None


class _Off:
    """The span of no recorder: enters and leaves, doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class Span:
    """One span: ``name``, ``id``, ``parent`` (an id, or None), ``start`` and
    ``end`` (``time.perf_counter()``), ``attrs`` and, for a span of a CUDA
    device, ``device_ms``: the time between its events on the stream."""
    __slots__ = ("name", "id", "parent", "start", "end", "attrs", "thread",
                 "_rec", "_device", "_events", "_allocator", "_stats",
                 "_range", "_device_ms")

    def __init__(self, rec: "Recorder", name: str, device, allocator,
                 attrs: dict) -> None:
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.id = next(rec._ids)
        self.parent = self.start = self.end = None
        self.thread = threading.get_ident()
        self._device = device
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if _is_cuda(device) else None)
        self._allocator = allocator if _is_cuda(allocator) else None
        self._stats = self._range = self._device_ms = None

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._rec.spans.append(self)
        if torch._C._autograd._profiler_enabled():
            self._range = _record_function(self.name)
            self._range.__enter__()
        if self._allocator is not None:
            self._stats = _allocator_counts(self._allocator)
        if self._events is not None:
            self._events[0].record(torch.cuda.current_stream(self._device))
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._stats is not None:
            after = _allocator_counts(self._allocator)
            self.attrs["mallocs"] = after[0] - self._stats[0]
            self.attrs["alloc_retries"] = after[1] - self._stats[1]
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec._stack().pop()

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on its stream (waits
        for the second), or None for a span without events."""
        if self._events is None or self.end is None:
            return None
        if self._device_ms is None:
            self._events[1].synchronize()
            self._device_ms = self._events[0].elapsed_time(self._events[1])
        return self._device_ms


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _allocator_counts(device) -> tuple[int, int]:
    """(device mallocs plus frees, allocation retries) of the caching
    allocator on ``device`` so far."""
    s = torch.cuda.memory_stats_as_nested_dict(device)
    return (s.get("num_device_alloc", 0) + s.get("num_device_free", 0),
            s.get("num_alloc_retries", 0))


class Recorder:
    """The spans of one recording, in the order they opened."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._gc_start: dict = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _gc(self, phase: str, info: dict) -> None:
        thread = threading.get_ident()
        if phase == "start":
            self._gc_start[thread] = _clock()
            return
        start = self._gc_start.pop(thread, None)
        if start is None:
            return
        s = Span(self, "gc", None, None,
                 {"generation": info["generation"],
                  "collected": info["collected"]})
        stack = self._stack()
        s.parent = stack[-1].id if stack else None
        s.start, s.end = start, _clock()
        self.spans.append(s)


def span(name: str, device=None, allocator=None, **attrs):
    """A context recording span ``name`` with ``attrs`` while a recorder is
    active, else the shared context that does nothing.  ``device``: record
    the span's time on that device's current stream where it is a CUDA
    device; ``allocator``: count that CUDA device's allocator calls over
    it."""
    if active is None:
        return OFF
    return Span(active, name, device, allocator, attrs)


def since(t: float | None) -> float | None:
    """Seconds from ``t`` (a ``stamp()``) to now while recording, else
    None."""
    if active is None or t is None:
        return None
    return _clock() - t


def stamp() -> float | None:
    """The span clock now while recording, else None."""
    if active is None:
        return None
    return _clock()


def start() -> Recorder:
    """Start recording into a new ``Recorder``, and return it."""
    global active
    if active is not None:
        raise RuntimeError("a telemetry recorder is already active")
    active = Recorder()
    gc.callbacks.append(active._gc)
    return active


def stop() -> Recorder | None:
    """Stop recording; returns the recorder that was active, if any."""
    global active
    rec, active = active, None
    if rec is not None and rec._gc in gc.callbacks:
        gc.callbacks.remove(rec._gc)
    return rec
