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
name, checking each leaf's shape and dtype.  ``ReplicaPlacer`` (WOW's
placement of shard replicas over hosts) stays in the JAX package.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: dict) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(path, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(flatten_state(state).items()):
            dtype = _DTYPE_NAMES[leaf.dtype]
            arr = leaf.detach()
            if leaf.dtype == torch.bfloat16:   # numpy has no bfloat16
                arr = arr.float()
            arr = arr.cpu().numpy()
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(path, fn), arr)
            manifest["leaves"].append({"name": name, "file": fn,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._gc()
        return path

    def latest_step(self) -> int | None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_")
            and os.path.exists(os.path.join(self.dir, d, "manifest.json")))
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, state: dict, step: int | None = None):
        """Copy checkpoint ``step`` (default: the latest) into ``state`` in
        place, leaf by leaf by name; every leaf of ``state`` must be in the
        checkpoint with its shape and dtype.  Returns (state, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            entries = {e["name"]: e for e in json.load(f)["leaves"]}
        for name, leaf in flatten_state(state).items():
            entry = entries.get(name)
            if entry is None:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            if (tuple(entry["shape"]) != tuple(leaf.shape)
                    or entry["dtype"] != _DTYPE_NAMES[leaf.dtype]):
                raise ValueError(
                    f"{name}: checkpoint has {entry['dtype']} "
                    f"{entry['shape']}, the state {_DTYPE_NAMES[leaf.dtype]} "
                    f"{list(leaf.shape)}")
            arr = np.load(os.path.join(path, entry["file"]))
            leaf.copy_(torch.from_numpy(arr).to(leaf.dtype))
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
