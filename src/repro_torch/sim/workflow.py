"""Workflow container used by the simulator and the workload generators:
the reference's ``repro/sim/workflow.py`` on the port's ``core/types.py``."""
from __future__ import annotations

import dataclasses

from ..core.types import FileSpec, TaskSpec


@dataclasses.dataclass
class Workflow:
    name: str
    tasks: dict[int, TaskSpec]
    files: dict[int, FileSpec]
    abstract_edges: dict[str, set[str]]

    def consumers_of(self, file_id: int) -> set[int]:
        return self.files[file_id].consumers

    # ------------------------------------------------------ id namespacing
    def id_bounds(self) -> tuple[int, int]:
        """(task id span, file id span): one past the largest local id."""
        t_span = 1 + max(self.tasks) if self.tasks else 0
        f_span = 1 + max(self.files) if self.files else 0
        return t_span, f_span

    def namespaced(self, task_base: int, file_base: int,
                   prefix: str = "") -> "Workflow":
        """A deep copy rebased into a per-instance id namespace.

        The open-loop traffic engine admits many concurrent instances of
        (possibly the same) workflow template; each is rebased onto bases
        allocated from the engine's running counters so task ids, file ids
        and (via the prefixed abstract names) rank/priority namespaces never
        collide between tenants or instances.  ``prefix`` is prepended to
        the workflow name and every abstract task name."""
        tasks = {t.id + task_base: t.rebased(task_base, file_base, prefix)
                 for t in self.tasks.values()}
        files = {f.id + file_base: f.rebased(task_base, file_base)
                 for f in self.files.values()}
        edges = {prefix + a: {prefix + b for b in succs}
                 for a, succs in self.abstract_edges.items()}
        return Workflow(prefix + self.name, tasks, files, edges)

    def validate(self) -> None:
        """Structural sanity: every input is produced by exactly one task,
        the physical DAG is acyclic, consumer sets are consistent."""
        producers: dict[int, int] = {}
        for t in self.tasks.values():
            for f in t.outputs:
                if f in producers:
                    raise ValueError(f"file {f} produced twice")
                producers[f] = t.id
        indeg: dict[int, int] = {t.id: 0 for t in self.tasks.values()}
        succs: dict[int, list[int]] = {t.id: [] for t in self.tasks.values()}
        for t in self.tasks.values():
            for f in t.inputs:
                if f not in producers:
                    raise ValueError(f"task {t.id} consumes unproduced file {f}")
                succs[producers[f]].append(t.id)
                indeg[t.id] += 1
                if t.id not in self.files[f].consumers:
                    raise ValueError(f"file {f} consumer set misses task {t.id}")
        # Kahn cycle check
        stack = [tid for tid, d in indeg.items() if d == 0]
        seen = 0
        while stack:
            tid = stack.pop()
            seen += 1
            for s in succs[tid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        if seen != len(self.tasks):
            raise ValueError("physical task graph contains a cycle")

    # Table-I style summary
    def total_input_bytes(self) -> int:
        return sum(t.dfs_inputs for t in self.tasks.values())

    def total_generated_bytes(self) -> int:
        return sum(f.size for f in self.files.values()) + sum(
            t.dfs_outputs for t in self.tasks.values())

    def n_physical(self) -> int:
        return len(self.tasks)

    def n_abstract(self) -> int:
        return len({t.abstract for t in self.tasks.values()})
