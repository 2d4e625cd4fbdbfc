"""The program's own spans (``repro_torch.telemetry``) for the per-layer
readers of a traced run, and the profiler's view of them.

A reader of these calls ``record()`` when it is imported.  ``Context``
imports the readers for ``--trace 1`` alone, so a traced run records from
its set-up on and an untraced one pays only the program's off path.  The
first reader to read stops the recorder and keeps its spans on the run
(``spans``); readers take the window's steps that the profiler did not
trace (``steps``).  While the profiler runs, each program span is also a
host range of its name in the trace (``ranges``, ``launches``,
``idle_inside``).  A program without the recorder records nothing, and the
readers then read None."""
from __future__ import annotations

import torch

from .trace import PREFIX, _union

try:
    from repro_torch import telemetry
except ImportError:         # a program from before the recorder
    telemetry = None

_SPANS, _KIDS = "program_spans", "program_children"


def record() -> None:
    """Turn the program's recorder on, where the program has one and it is
    off."""
    if telemetry is not None and telemetry.active is None:
        telemetry.start()


def spans(run) -> list:
    """Every span the run recorded, the recorder stopped at the first
    call."""
    if _SPANS not in run.values:
        rec = None if telemetry is None else telemetry.stop()
        run.values[_SPANS] = [] if rec is None else rec.spans
    return run.values[_SPANS]


def _inside(run, s) -> bool:
    """Whether span ``s`` ended and lies in the window, outside the traced
    stretch."""
    return (s.end is not None and run.t0 is not None
            and run.t0 <= s.start and s.end <= run.t1
            and run.untraced_seconds(s.start, s.end) == s.end - s.start)


def steps(run, name: str) -> list:
    """The top-level spans ``name`` (``train.step``, ``engine.step``) of the
    window that the profiler did not trace."""
    return [s for s in spans(run)
            if s.name == name and s.parent is None and _inside(run, s)]


def within(run, top, name: str) -> list:
    """The spans ``name`` at any depth under span ``top``."""
    if _KIDS not in run.values:
        kids: dict = {}
        for s in spans(run):
            kids.setdefault(s.parent, []).append(s)
        run.values[_KIDS] = kids
    kids, out, todo = run.values[_KIDS], [], [top]
    while todo:
        for c in kids.get(todo.pop().id, ()):
            if c.name == name:
                out.append(c)
            todo.append(c)
    return out


def per_step(run, step: str, name: str) -> list:
    """For each of ``steps(run, step)``, its spans ``name`` at any depth."""
    return [within(run, top, name) for top in steps(run, step)]


def stream_ms(found: list) -> float | None:
    """The mean over ``found`` (each a list of spans) of their summed
    stream time, in ms; None where nothing was found or a span has no
    CUDA events (the CPU)."""
    ms = [[s.device_ms for s in group] for group in found]
    if not ms or any(m is None for group in ms for m in group):
        return None
    return sum(map(sum, ms)) / len(ms)


def mean_attr(tops: list, key: str) -> float | None:
    """The mean of attribute ``key`` over spans ``tops``; None where one
    lacks it (the allocator counts of the CPU)."""
    if not tops or any(key not in s.attrs for s in tops):
        return None
    return sum(s.attrs[key] for s in tops) / len(tops)


def untraced_gc_seconds(run) -> float:
    """Seconds of garbage collection, in any thread, in the window outside
    the traced stretch."""
    return sum(s.seconds for s in spans(run)
               if s.name == "gc" and _inside(run, s))


# ------------------------------------------------------------ the profiler
def _events(run) -> list:
    tr = run.tracer
    if tr is None or run.device.type != "cuda":
        return []
    return list(tr._prof.events())


def ranges(run, name: str) -> list:
    """The host ranges of program span ``name`` in the trace: its CPU
    events."""
    cpu = torch.autograd.DeviceType.CPU
    return [e for e in _events(run) if e.name == name
            and e.device_type == cpu]


def _mirrors(run, events) -> set:
    """The names of the host ranges, which the trace mirrors on the device
    as annotations over their kernels: no operations of their own."""
    return ({e.name for e in events
             if getattr(e, "is_user_annotation", False)}
            | {s.name for s in spans(run)}
            | {e.name for e in events if e.name.startswith(PREFIX)})


def launches(run, name: str) -> int:
    """The device operations (kernels, copies, fills) launched under the
    host ranges ``name``: each under the innermost host operation whose
    call launched it, counted once."""
    events = _events(run)
    mirrors = _mirrors(run, events)
    n = 0
    for e in events:
        if not e.kernels:
            continue
        up = e
        while up is not None and up.name != name:
            up = up.cpu_parent
        if up is not None:
            n += sum(k.name not in mirrors for k in e.kernels)
    return n


def idle_inside(run, name: str) -> float:
    """Seconds the device ran no operation while the host was inside a
    range ``name`` of the trace."""
    cuda = torch.autograd.DeviceType.CUDA
    events = _events(run)
    mirrors = _mirrors(run, events)
    busy = _union((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == cuda and e.name not in mirrors)
    idle = 0.0
    for r in ranges(run, name):
        lo, hi = r.time_range.start, r.time_range.end
        covered = sum(min(e, hi) - max(s, lo) for s, e in busy
                      if s < hi and e > lo)
        idle += (hi - lo) - covered
    return idle / 1e6
