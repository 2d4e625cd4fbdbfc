"""Kubernetes dry-run adapter: render placements as pod specs, apply nothing.

WOW's prototype pins Nextflow tasks to nodes by handing Kubernetes pod
specs with node affinity to the cluster; this stub reproduces the
*serialization* half of that path with zero cluster dependencies.  Each
``StartTask`` decision becomes a v1 Pod manifest whose required node
affinity names the chosen node, with the task's declared memory/cores as
both requests and limits (the paper's RM treats declarations as hard
reservations, §II-A).  Each ``StartCop`` becomes a v1 Job pinned to the
COP's target node -- the shape a copy-container implementation would take.

Everything here is pure dict/JSON construction (stdlib only); nothing
talks to a cluster.  :class:`K8sDryRun` wraps any runtime adapter
(``core/adapter.py``) and turns ``schedule()`` decisions into manifests,
so it composes with the mock RM or any other runtime.

This is the reference's ``repro/runtime/k8s_dryrun.py``, copied as it is:
the manifests are byte for byte the reference's.
"""
from __future__ import annotations

import json
import re
from typing import Optional

from ..core.types import StartCop, StartTask, TaskSpec


def node_name(node_id: int) -> str:
    return f"node-{node_id}"


def _dns1123(name: str) -> str:
    """Sanitize an abstract task name into a DNS-1123 label."""
    s = re.sub(r"[^a-z0-9-]+", "-", name.lower()).strip("-")
    return (s or "task")[:40]


def _affinity(node_id: int) -> dict:
    return {
        "nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{
                    "matchExpressions": [{
                        "key": "kubernetes.io/hostname",
                        "operator": "In",
                        "values": [node_name(node_id)],
                    }],
                }],
            },
        },
    }


def _resources(mem: int, cores: float) -> dict:
    amounts = {"memory": str(int(mem)), "cpu": f"{int(round(cores * 1000))}m"}
    return {"requests": dict(amounts), "limits": dict(amounts)}


def pod_manifest(task: TaskSpec, node_id: int, *, namespace: str = "wow",
                 image: str = "workflow-task:latest") -> dict:
    """A v1 Pod running ``task`` pinned to ``node_id``."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{_dns1123(task.abstract)}-{task.id}",
            "namespace": namespace,
            "labels": {
                "app.kubernetes.io/managed-by": "wow-scheduler",
                "wow.repro/task-id": str(task.id),
                "wow.repro/abstract": _dns1123(task.abstract),
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "affinity": _affinity(node_id),
            "containers": [{
                "name": "task",
                "image": image,
                "resources": _resources(task.mem, task.cores),
            }],
        },
    }


def cop_job_manifest(plan, *, namespace: str = "wow",
                     image: str = "wow-copy:latest") -> dict:
    """A v1 Job executing COP ``plan`` on its target node.  The transfer
    list rides along as an annotation so a copy container could replay it."""
    transfers = [{"file": tr.file_id, "bytes": tr.size,
                  "from": node_name(tr.src), "to": node_name(tr.dst)}
                 for tr in plan.transfers]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": f"cop-{plan.id}-task-{plan.task_id}",
            "namespace": namespace,
            "labels": {
                "app.kubernetes.io/managed-by": "wow-scheduler",
                "wow.repro/cop-id": str(plan.id),
                "wow.repro/task-id": str(plan.task_id),
            },
            "annotations": {
                "wow.repro/transfers": json.dumps(transfers),
                "wow.repro/total-bytes": str(plan.total_bytes),
            },
        },
        "spec": {
            "template": {
                "spec": {
                    "restartPolicy": "Never",
                    "affinity": _affinity(plan.target),
                    "containers": [{"name": "copy", "image": image}],
                },
            },
        },
    }


class K8sDryRun:
    """Collect an adapter's placement decisions as Kubernetes manifests.

    ``step()`` calls ``adapter.schedule()`` once and renders every decision;
    the caller stays responsible for feeding the adapter (submit /
    completion callbacks), exactly as with any other runtime.
    """

    def __init__(self, adapter, *, namespace: str = "wow",
                 specs: Optional[dict[int, TaskSpec]] = None) -> None:
        self.adapter = adapter
        self.namespace = namespace
        # WowAdapter retains specs; bare cores need them passed in
        self._specs = specs if specs is not None \
            else getattr(adapter, "_specs", {})
        self.manifests: list[dict] = []

    def _spec_of(self, task_id: int) -> TaskSpec:
        try:
            return self._specs[task_id]
        except KeyError:
            raise KeyError(
                f"no TaskSpec retained for task {task_id}; pass specs= to "
                f"K8sDryRun") from None

    def step(self) -> list[dict]:
        rendered: list[dict] = []
        for act in self.adapter.schedule():
            if isinstance(act, StartTask):
                rendered.append(pod_manifest(
                    self._spec_of(act.task_id), act.node,
                    namespace=self.namespace))
            elif isinstance(act, StartCop):
                rendered.append(cop_job_manifest(
                    act.plan, namespace=self.namespace))
        self.manifests.extend(rendered)
        return rendered

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.manifests, indent=indent)
