"""Task prioritization (paper §III-B "Task prioritization").

Priority is (rank, total input size): rank is the length of the longest path
from the task to a sink in the *abstract* workflow DAG -- tasks many others
depend on run first -- and input size breaks ties (big inputs => likely long
=> straggler risk => start early).

The abstract DAG is known to dynamic engines (Nextflow ships it via the
Common Workflow Scheduler interface, §IV-A) even though physical tasks appear
only at runtime, so rank is computed on abstract task names.

The reference's ``repro/core/priority.py``, copied as it is.
"""
from __future__ import annotations

from collections import deque

from .types import TaskSpec


def abstract_ranks(edges: dict[str, set[str]]) -> dict[str, int]:
    """Longest-path-to-sink for every abstract task.

    ``edges[a]`` is the set of abstract successors of ``a``.  Sinks get rank
    0, a task's rank is 1 + max(rank of successors).  Raises on cycles (the
    abstract DAG of a Nextflow workflow is acyclic).
    """
    nodes = set(edges)
    for succs in edges.values():
        nodes |= succs
    indeg: dict[str, int] = {n: 0 for n in nodes}
    for a, succs in edges.items():
        for b in succs:
            indeg[b] += 1
    # reverse-topological via Kahn on the forward graph
    order: list[str] = []
    q = deque(n for n in nodes if indeg[n] == 0)
    while q:
        n = q.popleft()
        order.append(n)
        for b in edges.get(n, ()):  # forward edges
            indeg[b] -= 1
            if indeg[b] == 0:
                q.append(b)
    if len(order) != len(nodes):
        raise ValueError("abstract workflow graph contains a cycle")
    rank: dict[str, int] = {n: 0 for n in nodes}
    for n in reversed(order):
        for b in edges.get(n, ()):
            rank[n] = max(rank[n], rank[b] + 1)
    return rank


# Input sizes vary over ~15 orders of magnitude less than 2**50, so packing
# (rank, size) into one float keeps the paper's lexicographic order while the
# ILP objective stays a plain weighted sum.
_SIZE_SCALE = float(2**50)


def priority_value(rank: int, input_bytes: int) -> float:
    """Encode the paper's lexicographic (rank, input size) order as a float.

    rank dominates; input bytes break ties.  Strictly positive as required
    (t_p in R_{>0}).
    """
    frac = min(float(input_bytes), _SIZE_SCALE - 1.0) / _SIZE_SCALE
    return float(rank) + 1.0 + frac


def assign_priorities(
    tasks: list[TaskSpec],
    ranks: dict[str, int],
    file_sizes: dict[int, int],
) -> None:
    """Fill ``task.rank`` and ``task.priority`` in place.

    Input sizes are known when a task becomes ready (all inputs have been
    computed, §III-B), so callers invoke this at submission time.
    """
    for t in tasks:
        r = ranks.get(t.abstract, 0)
        size = t.dfs_inputs + sum(file_sizes[f] for f in t.inputs)
        t.rank = r
        t.priority = priority_value(r, size)
