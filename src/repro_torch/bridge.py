"""Bridges from the JAX package's state into this package's: the parameter
tree (and its optimizer state), as numpy arrays, into state dicts; and the
WOW core's cluster and workload state, as plain tuples or dicts, into the
port's types (``wow_specs_from_plain``, ``actions_to_plain``).

    state = params_from_jax(jax.device_get(jax_model.init(key)))
    model = Model(cfg, device="cpu").load_state(state)
    opt_state = opt_state_from_jax(jax.device_get(jax_opt.init(params)))

Leaf by leaf: the nested dict's paths become dotted state-dict keys
(``layers.attn.wq``) and the stacked-over-layers layout is kept, so each
leaf is a plain copy.  bfloat16 leaves go through float32 in numpy (numpy
has no bfloat16 of its own) and are cast back in torch; float32 to
bfloat16 and back is exact.  This module never imports JAX: the caller
hands it numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import FileSpec, NodeState, TaskSpec
from .models.api import flatten


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())   # jax.device_get gives read-only arrays


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into {dotted name: tensor}."""
    return {name: _to_torch(leaf) for name, leaf in flatten(tree).items()}


def opt_state_from_jax(state: dict) -> dict:
    """The JAX ``AdamW`` state, as numpy arrays, in this package's layout:
    {"m": {dotted name: tensor}, "v": ..., "count": 0-d int32, and "ef"
    with bf16 gradient compression}."""
    out = {k: params_from_jax(v) for k, v in state.items()
           if isinstance(v, dict)}
    out["count"] = _to_torch(state["count"]).to(torch.int32)
    return out


def _spec(cls, plain):
    """One dataclass from a tuple of its fields in order, or a dict of
    them by name (``dataclasses.astuple`` / ``asdict`` of either package's
    instance)."""
    if isinstance(plain, dict):
        return cls(**plain)
    return cls(*plain)


def wow_specs_from_plain(*, nodes=(), tasks=(), files=(),
                         replicas=None) -> dict:
    """The WOW core's state in plain form as the port's types.

    ``nodes``, ``tasks`` and ``files`` are iterables of ``NodeState``,
    ``TaskSpec`` and ``FileSpec`` fields (tuples in field order, or dicts
    by name); ``replicas`` maps a file id to the nodes holding it, the
    first the one it was registered on.  Returns ``{"nodes": {id:
    NodeState}, "tasks": {id: TaskSpec}, "files": {id: FileSpec},
    "replicas": {file id: tuple of nodes}}``, each dict in the order given
    (node order is the canonical enumeration order), sequences as tuples
    and consumer sets as sets, as the reference's constructors hold them."""
    out_nodes = {}
    for plain in nodes:
        n = _spec(NodeState, plain)
        out_nodes[n.id] = n
    out_tasks = {}
    for plain in tasks:
        t = _spec(TaskSpec, plain)
        t.inputs = tuple(t.inputs)
        t.outputs = tuple(t.outputs)
        out_tasks[t.id] = t
    out_files = {}
    for plain in files:
        f = _spec(FileSpec, plain)
        f.consumers = set(f.consumers)
        out_files[f.id] = f
    out_reps = {fid: tuple(locs) for fid, locs in (replicas or {}).items()}
    return {"nodes": out_nodes, "tasks": out_tasks, "files": out_files,
            "replicas": out_reps}


def actions_to_plain(actions) -> list[tuple]:
    """Scheduler actions of either package as tuples, for comparing action
    streams element for element: ``("task", task, node)`` for a
    ``StartTask``; ``("cop", cop id, task, target, ((file, size, src, dst),
    ...), price, total bytes)`` for a ``StartCop``."""
    out = []
    for a in actions:
        if not hasattr(a, "plan"):           # StartTask
            out.append(("task", a.task_id, a.node))
            continue
        p = a.plan
        out.append(("cop", p.id, p.task_id, p.target,
                    tuple(dataclasses.astuple(tr) for tr in p.transfers),
                    p.price, p.total_bytes))
    return out
