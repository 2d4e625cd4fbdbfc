"""The arithmetic of the end-to-end metrics: percentiles and rates.  Plain
Python, so the CPU tests hold it on hand-made inputs."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank over
    ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no samples")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: float, seconds: float) -> float:
    """``count`` over ``seconds``, refusing an empty window."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds


def whole_steps_rate(step_ends, t0: float, units_per_step: float) -> float:
    """The rate of whole steps: ``units_per_step`` times the steps that
    ended after ``t0`` (each started where the one before it ended), over
    the time from ``t0`` to the last step's end."""
    ends = [t for t in step_ends if t > t0]
    if not ends:
        raise ValueError("no whole step in the window")
    return rate(units_per_step * len(ends), ends[-1] - t0)
