"""Checkpoints in the reference's on-disk format
(``repro/runtime/checkpoint.py::CheckpointManager``), so that a checkpoint
of either package restores in the other:

    <dir>/step_<n:08d>/manifest.json    {"step", "leaves": [{"name", "file",
                                          "shape", "dtype"}, ...]}
    <dir>/step_<n:08d>/leaf_<i:05d>.npy one leaf each; bfloat16 stored as
                                         float32, its dtype in the manifest

A state is a nested dict of tensors; a leaf's name joins its keys with "/",
and the dotted parameter names of a flat level are split at the dots
(``params/layers/attn/wq``, ``opt/m/layers/attn/wq``, ``opt/count``).  The
reference restores by position, in ``jax.tree`` order, which sorts the keys
of every level; the port writes its leaves in that order and restores by
name, checking each leaf's shape and dtype.  ``ReplicaPlacer`` is WOW's
placement of shard replicas over hosts, on the port's DPS.

A checkpoint holds whole leaves, as the reference's does (its
``np.asarray`` gathers a sharded ``jax.Array``).  Given the ``model`` of a
state on a mesh, ``save`` gathers each leaf that is the rank's part of a
parameter (the parameter, or its AdamW moments and error-feedback buffer
beside it) over every axis of its spec, along the dims the spec splits:
the parameter's ``model.sharded`` spec ("tp" or "fsdp"), or for a ZeRO-1
moment its ``opt_shardings(..., zero1=True)`` spec, told apart by the
leaf's shape.  Global rank 0 writes, and every rank waits at a barrier (in
a group of more than one rank, ``save`` without such a model raises);
``restore`` reads whole leaves and keeps each rank's part of the same spec
(``launch/shardings.local_slice``).  So a checkpoint crosses mesh shapes
and modes, and crosses with the JAX package both ways.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import DataPlacementService, FileSpec
from ..launch.collectives import gather_leaf
from ..launch.mesh import coordinate
from ..launch.shardings import local_shape, local_slice, opt_shardings

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int32: "int32",
                torch.int64: "int64"}


def _paths(state: dict, prefix: tuple = ()) -> dict:
    out = {}
    for key, val in state.items():
        path = prefix + tuple(key.split("."))
        if isinstance(val, dict):
            out.update(_paths(val, path))
        else:
            out[path] = val
    return out


def flatten_state(state: dict) -> dict:
    """{"a/b/c": tensor} of a nested dict, in the reference's leaf order
    (the keys of every level sorted)."""
    out = _paths(state)
    return {"/".join(p): out[p] for p in sorted(out)}


def _slices(state: dict, model) -> dict:
    """{leaf name: (spec, whole shape)} of the leaves of ``state`` that are
    this rank's parts of a parameter of ``model``: a leaf whose name ends
    in a parameter's path (``params/layers/attn/wq``,
    ``opt/m/layers/attn/wq``) and whose shape is the part of the
    parameter's spec (``model.sharded``) or, for a ZeRO-1 moment, of its
    ``opt_shardings(..., zero1=True)`` spec; empty off a mesh."""
    if model is None or model.mesh is None:
        return {}
    mesh, wholes = model.mesh, model.whole_shapes
    zero1 = opt_shardings(wholes, mesh, zero1=True, mode=model.mode)["m"]
    paths = {n.replace(".", "/"): n for n in wholes}
    out = {}
    for name, leaf in flatten_state(state).items():
        hits = [p for p in paths if name == p or name.endswith("/" + p)]
        if not hits:
            continue
        param = paths[max(hits, key=len)]
        whole = wholes[param]
        specs = (model.sharded.get(param, ()), zero1[param])
        spec = next((s for s in specs
                     if local_shape(whole, s, mesh) == tuple(leaf.shape)),
                    None)
        if spec is None:
            raise ValueError(
                f"{name} {tuple(leaf.shape)}: neither the part of {param} "
                f"{whole} that its spec {specs[0]} gives a rank nor its "
                f"ZeRO-1 moment's ({specs[1]})")
        if any(e is not None for e in spec):
            out[name] = (spec, whole)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    @torch.no_grad()
    def save(self, step: int, state: dict, model=None) -> str:
        """Write ``state``'s leaves whole.  With the ``model`` of a state on
        a mesh, every rank calls it: the slices are gathered over "model",
        global rank 0 writes, and the ranks meet at a barrier before it
        returns.  In a process group of more than one rank, a call without
        a model on a mesh raises, before anything is written: each rank
        would write the leaves it holds under the whole leaves' names."""
        on_mesh = model is not None and model.mesh is not None
        if (not on_mesh and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise ValueError(
                f"save: {dist.get_world_size()} ranks would each write the "
                f"leaves they hold into {self.dir}; pass the model on a mesh "
                f"(model=), whose slices are gathered and written once")
        path = os.path.join(self.dir, f"step_{step:08d}")
        slices = _slices(state, model)
        writer = not on_mesh or dist.get_rank() == 0
        if writer:
            os.makedirs(path, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(flatten_state(state).items()):
            dtype = _DTYPE_NAMES[leaf.dtype]
            arr = leaf.detach()
            for d, axes in enumerate(slices.get(name, ((),))[0]):
                if axes is not None:
                    arr = gather_leaf(arr, model.mesh, d, axes)
            if not writer:
                continue
            if leaf.dtype == torch.bfloat16:   # numpy has no bfloat16
                arr = arr.float()
            arr = arr.cpu().numpy()
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(path, fn), arr)
            manifest["leaves"].append({"name": name, "file": fn,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        if writer:
            with open(os.path.join(path, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            self._gc()
        if on_mesh:
            dist.barrier()
        return path

    def latest_step(self) -> int | None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_")
            and os.path.exists(os.path.join(self.dir, d, "manifest.json")))
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, state: dict, step: int | None = None, model=None):
        """Copy checkpoint ``step`` (default: the latest) into ``state`` in
        place, leaf by leaf by name; every leaf of ``state`` must be in the
        checkpoint with its dtype and its shape, the whole leaf's for the
        rank's slices of the ``model`` of a state on a mesh, of which the
        rank keeps its own.  Returns (state, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            entries = {e["name"]: e for e in json.load(f)["leaves"]}
        slices = _slices(state, model)
        for name, leaf in flatten_state(state).items():
            entry = entries.get(name)
            if entry is None:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            whole = slices[name][1] if name in slices else tuple(leaf.shape)
            if (tuple(entry["shape"]) != whole
                    or entry["dtype"] != _DTYPE_NAMES[leaf.dtype]):
                raise ValueError(
                    f"{name}: checkpoint has {entry['dtype']} "
                    f"{entry['shape']}, the state {_DTYPE_NAMES[leaf.dtype]} "
                    f"{list(whole)}")
            arr = torch.from_numpy(np.load(os.path.join(path, entry["file"])))
            if name in slices:
                arr = local_slice(arr, slices[name][0], model.mesh,
                                  coordinate(model.mesh))
            leaf.copy_(arr.to(leaf.dtype))
        return state, step

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            p = os.path.join(self.dir, f"step_{s:08d}")
            for fn in os.listdir(p):
                os.remove(os.path.join(p, fn))
            os.rmdir(p)


class ReplicaPlacer:
    """DPS-planned checkpoint-shard replica placement across hosts (the
    reference's ``repro/runtime/checkpoint.py::ReplicaPlacer``).

    ``place(shards)`` spreads ``replicas`` copies of each shard over hosts
    with the DPS greedy source/load balancing; ``survivors(lost)`` reports
    which shards are still recoverable peer-locally after failures.
    """

    def __init__(self, n_hosts: int, replicas: int = 2, seed: int = 0):
        self.n_hosts = n_hosts
        self.replicas = min(replicas, n_hosts)
        self.dps = DataPlacementService(seed=seed)

    def place(self, shard_sizes: list[int]) -> dict[int, list[int]]:
        """shard id -> host list, load-balanced by bytes."""
        load = [0] * self.n_hosts
        placement: dict[int, list[int]] = {}
        order = sorted(range(len(shard_sizes)),
                       key=lambda i: -shard_sizes[i])
        for i in order:
            hosts = sorted(range(self.n_hosts),
                           key=lambda h: (load[h], h))[:self.replicas]
            placement[i] = hosts
            for h in hosts:
                load[h] += shard_sizes[i]
            self.dps.register_file(
                FileSpec(id=i, size=shard_sizes[i], producer=-1), hosts[0])
            for h in hosts[1:]:
                self.dps.add_replica(i, h)
        self.load = load
        return placement

    def survivors(self, lost_hosts: set[int]) -> tuple[int, int]:
        """(#shards recoverable from surviving peers, #total)."""
        ok = 0
        total = 0
        for fid in self.dps.file_ids():
            total += 1
            if self.dps.locations(fid) - lost_hosts:
                ok += 1
        return ok, total
