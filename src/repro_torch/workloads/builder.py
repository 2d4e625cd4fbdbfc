"""Small builder DSL for constructing physical workflows (the reference's;
its draws stay a ``random.Random(seed)``)."""
from __future__ import annotations

import random

from ..core.types import FileSpec, TaskSpec
from ..sim.workflow import Workflow

GB = 1_000_000_000
MB = 1_000_000
GiB = 1024 ** 3


class WorkflowBuilder:
    def __init__(self, name: str, seed: int = 0) -> None:
        self.name = name
        self.rng = random.Random(seed)
        self.tasks: dict[int, TaskSpec] = {}
        self.files: dict[int, FileSpec] = {}
        self.abstract_edges: dict[str, set[str]] = {}
        self._next_task = 0
        self._next_file = 0
        self._file_producer_abstract: dict[int, str] = {}

    def task(
        self,
        abstract: str,
        inputs: list[int] | None = None,
        out_sizes: list[int] | None = None,
        dfs_inputs: int = 0,
        dfs_outputs: int = 0,
        compute: float = 0.0,
        cores: float = 2.0,
        mem: int = 4 * GiB,
    ) -> tuple[int, list[int]]:
        """Add one physical task; returns (task_id, output_file_ids)."""
        inputs = inputs or []
        out_sizes = out_sizes or []
        tid = self._next_task
        self._next_task += 1
        out_ids: list[int] = []
        for size in out_sizes:
            fid = self._next_file
            self._next_file += 1
            self.files[fid] = FileSpec(id=fid, size=int(size), producer=tid)
            self._file_producer_abstract[fid] = abstract
            out_ids.append(fid)
        for f in inputs:
            self.files[f].consumers.add(tid)
            src = self._file_producer_abstract[f]
            if src != abstract:
                self.abstract_edges.setdefault(src, set()).add(abstract)
        self.abstract_edges.setdefault(abstract, set())
        self.tasks[tid] = TaskSpec(
            id=tid, abstract=abstract, mem=int(mem), cores=float(cores),
            inputs=tuple(inputs), dfs_inputs=int(dfs_inputs),
            outputs=tuple(out_ids), dfs_outputs=int(dfs_outputs),
            compute_time=float(compute),
        )
        return tid, out_ids

    def uniform(self, lo: float, hi: float) -> float:
        return self.rng.uniform(lo, hi)

    def build(self) -> Workflow:
        wf = Workflow(self.name, self.tasks, self.files, self.abstract_edges)
        wf.validate()
        return wf


def scaled_count(n: int, scale: float, minimum: int = 1) -> int:
    return max(minimum, round(n * scale))
