"""The five workflow patterns of Fig. 3 (Bharathi et al. patterns).

Exact construction rules from the paper (§V-A):
* Task A always writes a random file of 0.8..1.0 GB (no workflow input).
* Tasks B and C read all their inputs and merge them into a single file.
* all_in_one:       100 x A -> 1 x B                     (101 tasks)
* chain:            100 x (A_i -> B_i)                   (200 tasks)
* fork:             1 x A -> 100 x B                     (101 tasks)
* group:            A_i (i=1..100) grouped by floor(i/3) (134 tasks)
* group_multiple:   group + second grouping floor(i/4)   (160 tasks)
"""
from __future__ import annotations

from .builder import GB, GiB, WorkflowBuilder

_A_COMPUTE = 10.0     # seconds: mostly-I/O generator task
_B_COMPUTE = 5.0      # seconds: merge task
_CORES = 2.0
_MEM = 4 * GiB


def _a_task(b: WorkflowBuilder) -> int:
    size = int(b.uniform(0.8, 1.0) * GB)
    _, outs = b.task("A", out_sizes=[size], compute=_A_COMPUTE,
                     cores=_CORES, mem=_MEM)
    return outs[0]


def _merge_task(b: WorkflowBuilder, abstract: str, inputs: list[int]) -> int:
    total = sum(b.files[f].size for f in inputs)
    _, outs = b.task(abstract, inputs=inputs, out_sizes=[total],
                     compute=_B_COMPUTE, cores=_CORES, mem=_MEM)
    return outs[0]


def all_in_one(scale: float = 1.0, seed: int = 0):
    b = WorkflowBuilder("all_in_one", seed)
    n = max(2, round(100 * scale))
    files = [_a_task(b) for _ in range(n)]
    _merge_task(b, "B", files)
    return b.build()


def chain(scale: float = 1.0, seed: int = 0):
    b = WorkflowBuilder("chain", seed)
    n = max(2, round(100 * scale))
    for _ in range(n):
        f = _a_task(b)
        _merge_task(b, "B", [f])
    return b.build()


def fork(scale: float = 1.0, seed: int = 0):
    b = WorkflowBuilder("fork", seed)
    n = max(2, round(100 * scale))
    f = _a_task(b)
    for _ in range(n):
        _merge_task(b, "B", [f])
    return b.build()


def group(scale: float = 1.0, seed: int = 0):
    b = WorkflowBuilder("group", seed)
    n = max(3, round(100 * scale))
    groups: dict[int, list[int]] = {}
    for i in range(1, n + 1):
        f = _a_task(b)
        groups.setdefault(i // 3, []).append(f)
    for g in sorted(groups):
        _merge_task(b, "B", groups[g])
    return b.build()


def group_multiple(scale: float = 1.0, seed: int = 0):
    b = WorkflowBuilder("group_multiple", seed)
    n = max(4, round(100 * scale))
    g3: dict[int, list[int]] = {}
    g4: dict[int, list[int]] = {}
    for i in range(1, n + 1):
        f = _a_task(b)
        g3.setdefault(i // 3, []).append(f)
        g4.setdefault(i // 4, []).append(f)
    for g in sorted(g3):
        _merge_task(b, "B", g3[g])
    for g in sorted(g4):
        _merge_task(b, "C", g4[g])
    return b.build()
