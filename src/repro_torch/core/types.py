"""Core data types shared by the WOW scheduler, its runtime adapters and the
mock resource manager: the reference's ``repro/core/types.py``, copied so
that the port imports nothing of ``repro``.  The fields, defaults and
methods are the reference's, so ``bridge.wow_specs_from_plain`` carries
either package's state into the other field for field.

Terminology follows the paper (Lehmann et al., CCGrid'25):

* ``TaskSpec``  -- a physical workflow task t_k = (t_m, t_c, N_prep, t_p).
* ``FileSpec``  -- an intermediate file tracked by the DPS (workflow *input*
  data stays in the DFS and is intentionally NOT tracked here, §III-A).
* ``CopPlan``   -- one atomic copy operation (COP): the full set of file
  transfers required to prepare one task on one target node (§IV-C).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional

# Node ids are small ints; the special location DFS_LOC marks data living in
# the distributed file system (readable from everywhere at network cost).
NodeId = int
DFS_LOC: NodeId = -1


class TaskState(enum.Enum):
    BLOCKED = "blocked"      # known but some inputs not yet produced
    READY = "ready"          # submitted to the job queue
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class FileSpec:
    """An intermediate file under DPS control."""

    id: int
    size: int                      # bytes
    producer: int                  # task id that creates the file
    consumers: set[int] = dataclasses.field(default_factory=set)

    def __hash__(self) -> int:
        return self.id

    def rebased(self, task_base: int, file_base: int) -> "FileSpec":
        """A copy living in the (task_base, file_base) id namespace.

        Multi-tenant traffic runs many workflow *instances* through one
        engine/scheduler; rebasing each instance's dense local ids onto a
        per-instance base guarantees task/file ids never collide across
        concurrent instances (DESIGN.md "Open-loop traffic")."""
        return FileSpec(id=self.id + file_base, size=self.size,
                        producer=self.producer + task_base,
                        consumers={c + task_base for c in self.consumers})


@dataclasses.dataclass
class TaskSpec:
    """A physical task.  Resource requirements are user-declared (and thus
    possibly wrong, §II-A) -- the scheduler treats them as hard reservations,
    exactly like the paper's RM does."""

    id: int
    abstract: str                  # abstract task name (logical step)
    mem: int                       # bytes of main memory requested
    cores: float                   # CPU cores requested
    inputs: tuple[int, ...] = ()   # intermediate file ids (DPS-tracked)
    dfs_inputs: int = 0            # bytes read straight from the DFS
    outputs: tuple[int, ...] = ()  # file ids produced on completion
    dfs_outputs: int = 0           # bytes of final results pushed to the DFS
    compute_time: float = 0.0      # seconds of pure compute (sim only)
    priority: float = 0.0          # t_p, filled in by the priority module
    rank: int = 0                  # longest path to sink (abstract DAG)

    def __hash__(self) -> int:
        return self.id

    def rebased(self, task_base: int, file_base: int,
                prefix: str = "") -> "TaskSpec":
        """A copy in the (task_base, file_base) id namespace; ``prefix``
        additionally namespaces the abstract name so concurrent instances
        keep independent abstract DAGs (ranks/priorities never mix)."""
        return dataclasses.replace(
            self, id=self.id + task_base, abstract=prefix + self.abstract,
            inputs=tuple(f + file_base for f in self.inputs),
            outputs=tuple(f + file_base for f in self.outputs))


@dataclasses.dataclass
class NodeState:
    """Mutable per-node bookkeeping used by the scheduler."""

    id: NodeId
    mem: int                       # total memory
    cores: float                   # total cores
    # None means "fully free" -- a node legitimately constructed with zero
    # free resources (fully loaded, e.g. on elastic re-join) keeps its zeros.
    free_mem: Optional[int] = None
    free_cores: Optional[float] = None
    active_cops: int = 0           # COPs this node participates in

    def __post_init__(self) -> None:
        if self.free_mem is None:
            self.free_mem = self.mem
        if self.free_cores is None:
            self.free_cores = self.cores

    def fits(self, task: TaskSpec) -> bool:
        return task.mem <= self.free_mem and task.cores <= self.free_cores


@dataclasses.dataclass
class Transfer:
    """One file replica movement inside a COP."""

    file_id: int
    size: int
    src: NodeId
    dst: NodeId


@dataclasses.dataclass
class CopPlan:
    """An atomic copy operation preparing ``task_id`` on ``target``.

    ``transfers`` covers every input file missing on the target; the plan is
    applied all-or-nothing (paper: "COPs are atomic units ... none are added
    upon COP failure")."""

    id: int
    task_id: int
    target: NodeId
    transfers: list[Transfer]
    price: float                   # DPS price (traffic + max node load)
    total_bytes: int = 0

    def __post_init__(self) -> None:
        if not self.total_bytes:
            self.total_bytes = sum(t.size for t in self.transfers)

    @property
    def nodes(self) -> set[NodeId]:
        """All nodes participating in this COP (sources + target)."""
        out = {self.target}
        for t in self.transfers:
            out.add(t.src)
        return out


@dataclasses.dataclass
class StartTask:
    task_id: int
    node: NodeId


@dataclasses.dataclass
class StartCop:
    plan: CopPlan


Action = StartTask | StartCop


def sum_sizes(files: Iterable[FileSpec]) -> int:
    return sum(f.size for f in files)
