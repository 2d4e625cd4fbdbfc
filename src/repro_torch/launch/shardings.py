"""Sharding rules: parameter, optimizer, batch and cache specs for the
(data, model) mesh and the optional "pod" axis, one for one the reference's
``launch/shardings.py``.

Strategy (the reference's baseline):
  * tensor/expert parallel over "model": attention heads, the FFN's hidden
    dim, the expert dim, the vocabulary;
  * data parallel over ("pod", "data"): the batch dim of activations;
  * optimizer moments optionally ZeRO-1-sharded over "data" on top of the
    parameter's spec (``zero1=True``);
  * decode caches: the batch over the data axes when it divides, else the
    KV sequence dim (context-parallel decode of one long request).
Every rule falls back to replication when a dim does not divide.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry a tensor dim, each an axis name, a tuple of names or None (a tuple of
one name is that name, as JAX normalises it); ``()`` replicates.  The trees
are flat {dotted name: tensor or shape}, the port's state-dict keys.  The
rules read only the mesh's axes and sizes (``mesh.MeshSpec``), so a
production mesh's specs need no processes.

What this port carries out: ``shard_params`` gives each rank its slice of
every leaf that the mode's spec (``leaf_spec``) splits.  In "tp" mode that is
every leaf whose ``param_spec`` names "model" (tensor parallelism: the models
compute on the slices, ``models/attention.py``, ``mlp.py``, ``lm.py``); in
"fsdp" mode every leaf ``fsdp_spec`` splits, over the whole mesh (ZeRO-3: the
models gather each layer's leaves whole just before they use them and
reduce-scatter the gradients, ``models/common.gather_layer``; the experts stay
split over "model").  ``shard_batch`` gives its rows of a batch, over the data
axes ("tp") or over every axis ("fsdp"); ZeRO-1's moments
(``opt_shardings(..., zero1=True)``) are built by ``optim/adamw.AdamW.init``.
An fsdp batch smaller than the mesh has its rows over a prefix of the axes
and its sequence over the rest (``split_batch``): each rank holds one
contiguous slice of its rows' sequence, and the models attend across the
slices, pass the SSM state along them and route the MoE's slices as the
reference's blocks (``models/attention.py``, ``models/ssm.py``,
``models/mlp.py``); a leaf whose second dim the axes do not divide
(whisper's frames) lies whole on every rank beside the split tokens
(``split_axes``).  The
reference's ``constraint`` and
the models' ``maybe_constrain`` are hints to GSPMD's partitioner; eager
PyTorch has no partitioner, so they have no counterpart.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import torch
from torch.distributed.tensor import Replicate, Shard

from .mesh import MeshSpec, batch_axes, coordinate

if TYPE_CHECKING:          # models/api.py imports this module
    from ..models.config import ArchConfig


def _norm(entry):
    """An entry as JAX's ``PartitionSpec`` keeps it: a 1-tuple is its
    name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(entries) -> tuple:
    return tuple(_norm(e) for e in entries)


def _axis_size(mesh: MeshSpec, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list, torch.Size)) \
        else tuple(leaf.shape)


def _spec_with(mesh: MeshSpec, shape, axis: str,
               dims_priority: list[int]) -> tuple:
    """Shard the first divisible dim from ``dims_priority`` over ``axis``."""
    size = _axis_size(mesh, axis)
    spec: list[Any] = [None] * len(shape)
    for d in dims_priority:
        if d < len(shape) and shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axis
            break
    return _spec(spec)


# dims to try sharding over "model", by parameter name suffix; leading
# stacked-layer dims are skipped by the tensor's rank against the rule's
# base rank: (name suffix, base rank, dims priority in the base shape)
_MODEL_RULES: list[tuple[str, int, list[int]]] = [
    ("embed", 2, [0]),            # (V, D): shard vocab
    ("lm_head", 2, [1]),          # (D, V)
    ("enc_pos", 2, []),
    ("projector", 2, [1]),
    # head-dim TP only when the heads divide the axis, else replicate
    ("wq", 3, [1]),               # (D, H, hd)
    ("wk", 3, [1]),               # (D, K, hd)
    ("wv", 3, [1]),
    ("wo", 3, [0]),               # (H, hd, D)
    ("w_in", 2, [1]),             # (D, F) or (E, D, F) through the moe rule
    ("w_gate", 2, [1]),
    ("w_out", 2, [0]),            # (F, D)
    ("router", 2, []),            # (D, E): whole on every rank
    ("in_proj", 2, [1]),          # (D, K)
    ("out_proj", 2, [0]),         # (di, D)
    ("conv_w", 2, [1]),           # (k, C)
    ("conv_b", 1, [0]),
    ("norm", 1, []),
]

_MOE_LEAVES = {"w_in", "w_gate", "w_out"}


def _is_expert(name: str) -> bool:
    return "moe" in name and name.rsplit(".", 1)[-1] in _MOE_LEAVES


def param_spec(name: str, shape, mesh) -> tuple:
    mesh = MeshSpec.of(mesh)
    shape = _shape(shape)
    leaf = name.rsplit(".", 1)[-1]
    if _is_expert(name):
        # (E, D, F) / (E, F, D), maybe behind stacked-layer dims: expert
        # parallelism over "model"
        lead = len(shape) - 3
        spec: list[Any] = [None] * len(shape)
        if shape[lead] % mesh.shape["model"] == 0:
            spec[lead] = "model"
            return _spec(spec)
        # fewer experts than the axis: the hidden dim instead
        hidden_dim = lead + (2 if leaf in ("w_in", "w_gate") else 1)
        if shape[hidden_dim] % mesh.shape["model"] == 0:
            spec[hidden_dim] = "model"
        return _spec(spec)
    for suffix, base_rank, dims in _MODEL_RULES:
        if leaf == suffix:
            lead = len(shape) - base_rank
            if lead < 0:
                return ()
            return _spec_with(mesh, shape, "model", [lead + d for d in dims])
    return ()      # scales, biases, scalars: replicated


def param_shardings(params: dict, mesh, mode: str = "tp") -> dict:
    """{name: spec} of a flat parameter tree."""
    return {n: leaf_spec(n, p, mesh, mode) for n, p in params.items()}


def fsdp_spec(name: str, shape, mesh) -> tuple:
    """ZeRO-3: a parameter sharded over the whole mesh on its largest
    divisible dim (ties: the first); the experts stay EP-sharded over
    "model" (the all-to-all dispatch takes rank-local experts), one of
    their other dims over the remaining axes."""
    mesh = MeshSpec.of(mesh)
    shape = _shape(shape)
    allax = mesh.axis_names
    spec: list[Any] = [None] * len(shape)
    if _is_expert(name):
        lead = len(shape) - 3
        if shape[lead] % mesh.shape["model"] == 0:
            spec[lead] = "model"
        rest = tuple(a for a in allax if a != "model")
        nrest = _axis_size(mesh, rest)
        for dd in sorted(range(lead + 1, len(shape)), key=lambda i: -shape[i]):
            if shape[dd] % nrest == 0 and shape[dd] >= nrest:
                spec[dd] = rest
                break
        return _spec(spec)
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % mesh.size == 0 and shape[d] >= mesh.size:
            spec[d] = allax
            break
    return _spec(spec)


def fsdp_param_shardings(params: dict, mesh) -> dict:
    """{name: ``fsdp_spec``} of a flat parameter tree."""
    return {n: fsdp_spec(n, p, mesh) for n, p in params.items()}


def zero1_spec(base: tuple, shape, mesh) -> tuple:
    """A parameter's spec with its largest unsharded dim over "data"
    (ZeRO-1 moment sharding)."""
    mesh = MeshSpec.of(mesh)
    shape = _shape(shape)
    size = mesh.shape["data"]
    spec = list(base) + [None] * (len(shape) - len(base))
    cand = [(shape[i], i) for i in range(len(shape))
            if spec[i] is None and shape[i] % size == 0 and shape[i] >= size]
    if cand:
        _, i = max(cand)
        spec[i] = "data"
    return _spec(spec)


def opt_shardings(params: dict, mesh, zero1: bool = False,
                  mode: str = "tp") -> dict:
    """The AdamW state's specs ({"m", "v": {name: spec}, "count": ()}):
    each moment as its parameter, ZeRO-1 on top with ``zero1`` in "tp"
    mode."""
    if mode == "fsdp":
        psh = fsdp_param_shardings(params, mesh)
        return {"m": dict(psh), "v": dict(psh), "count": ()}
    pspecs = param_shardings(params, mesh, mode)
    moment = {n: zero1_spec(s, params[n], mesh) if zero1 else s
              for n, s in pspecs.items()}
    return {"m": moment, "v": dict(moment), "count": ()}


# ------------------------------------------------------------------ batches
def batch_shardings(batch: dict, mesh, mode: str = "tp") -> dict:
    """The batch dim over the data axes ("tp") or over every axis
    ("fsdp"; a batch smaller than the mesh: the batch over the longest
    divisible prefix of axes and the sequence over the rest)."""
    mesh = MeshSpec.of(mesh)
    baxes = mesh.axis_names if mode == "fsdp" else batch_axes(mesh)
    n = _axis_size(mesh, baxes)

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) >= 1 and shape[0] % n == 0 and shape[0] >= n:
            return _spec((baxes, *([None] * (len(shape) - 1))))
        if mode == "fsdp" and len(shape) >= 2:
            for cut in range(len(baxes) - 1, 0, -1):
                bpre, brest = baxes[:cut], baxes[cut:]
                nb = _axis_size(mesh, bpre)
                ns = _axis_size(mesh, brest)
                if (shape[0] % nb == 0 and shape[0] >= nb
                        and shape[1] % ns == 0):
                    return _spec((bpre, brest,
                                  *([None] * (len(shape) - 2))))
        return ()
    return {k: one(v) for k, v in batch.items()}


def cache_shardings(cache: dict, cfg: ArchConfig, mesh) -> dict:
    """Decode-cache specs.  Layouts (``models/lm.py::init_decode_cache``):
    k/v (L,B,T,K,hd) or hybrid (nb,B,T,K,hd); conv (L,B,ck-1,C) or hybrid
    (nb,pb,B,ck-1,C); ssm (L,B,H,N,P) or hybrid (nb,pb,B,H,N,P); pos (B,)."""
    mesh = MeshSpec.of(mesh)
    baxes = batch_axes(mesh)
    nb = _axis_size(mesh, baxes)
    nm = mesh.shape["model"]

    def kv(shape):
        _, b, t, k, _ = shape
        spec: list[Any] = [None] * 5
        if b % nb == 0 and b >= nb:
            spec[1] = baxes
        elif t % nb == 0:
            spec[2] = baxes          # context-parallel decode (batch 1)
        if k % nm == 0 and k >= nm:
            spec[3] = "model"        # never hd: see the reference
        return _spec(spec)

    def generic(shape, batch_dim, model_dims):
        spec: list[Any] = [None] * len(shape)
        if shape[batch_dim] % nb == 0 and shape[batch_dim] >= nb:
            spec[batch_dim] = baxes
        for d in model_dims:
            if shape[d] % nm == 0 and shape[d] >= nm:
                spec[d] = "model"
                break
        return _spec(spec)

    hybrid = cfg.family == "hybrid"
    out = {}
    for key, leaf in cache.items():
        shape = _shape(leaf)
        if key in ("k", "v", "xk", "xv"):
            out[key] = kv(shape)
        elif key == "conv":
            out[key] = generic(shape, 2 if hybrid else 1, [len(shape) - 1])
        elif key == "ssm":
            out[key] = generic(shape, 2 if hybrid else 1, [len(shape) - 3])
        else:
            out[key] = ()
    return out


def decode_cache_specs(cache: dict, cfg: ArchConfig, mesh,
                       mode: str = "tp") -> dict:
    """The port's layout of a decode cache on ``mesh`` in ``mode``: every
    leaf but ``pos`` as ``cache_shardings`` lays it, in both modes (the
    rows over the batch axes where they divide the batch, else the k/v
    positions, context-parallel decode of a batch of one; the kv heads,
    the conv's channels and the ssm state's heads over "model" where they
    divide it); ``pos`` over the batch axes where they divide it (the
    reference leaves it whole beside its GSPMD rows)."""
    _check_mode(mode)
    rules = cache_shardings(cache, cfg, mesh)
    spec_of = MeshSpec.of(mesh)
    baxes = _spec((batch_axes(spec_of),))[0]
    out = dict(rules)
    if "pos" in cache:
        b = _axis_size(spec_of, _axes_of(baxes))
        n = _shape(cache["pos"])[0]
        out["pos"] = (baxes,) if n % b == 0 and n >= b else ()
    return out


# ------------------------------------------------- from specs to the ranks
def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis
    ``Shard(d)`` where the spec puts the axis on tensor dim d, else
    ``Replicate()``.  A dim over two axes (("pod", "data")) is
    ``Shard(d)`` on each; the DTensor splits it by the mesh's first axis,
    then each part by the next, so the entry must name its axes in the
    mesh's order (the rules' entries do) for the parts to be JAX's."""
    names = MeshSpec.of(mesh).axis_names
    for entry in spec:
        order = [names.index(a) for a in _axes_of(entry)]
        if order != sorted(order):
            raise ValueError(f"{entry}: a DTensor splits a dim over the "
                             f"mesh's axes in the mesh's order {names}")
    dim_of = {a: d for d, entry in enumerate(spec) for a in _axes_of(entry)}
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def local_slice(x: torch.Tensor, spec: tuple, mesh,
                coord: dict[str, int]) -> torch.Tensor:
    """The part of ``x`` that ``spec`` gives the rank at ``coord`` ({axis:
    index}), as a contiguous copy; ``x`` itself where ``spec`` splits
    nothing (no axis, or axes of size 1)."""
    mesh = MeshSpec.of(mesh)
    out = x
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:                   # the first axis is the major one
            parts, idx = parts * mesh.shape[a], idx * mesh.shape[a] + coord[a]
        if parts > 1:
            size = x.shape[d] // parts
            out = out.narrow(d, idx * size, size)
    if out is x:
        return x
    return out.clone(memory_format=torch.contiguous_format)


def model_dim(spec: tuple) -> int | None:
    """The dim that ``spec`` splits over "model", or None."""
    for d, entry in enumerate(spec):
        if "model" in _axes_of(entry):
            return d
    return None


def spec_axes(spec: tuple) -> tuple[str, ...]:
    """Every axis that ``spec`` names, in the order of its dims."""
    return tuple(a for entry in spec for a in _axes_of(entry))


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of ``local_slice`` of a leaf of ``shape``."""
    mesh = MeshSpec.of(mesh)
    shape = _shape(shape)
    return tuple(n // _axis_size(mesh, _axes_of(spec[d])) if d < len(spec)
                 else n for d, n in enumerate(shape))


def fsdp_gathers(name: str, shape, mesh) -> tuple:
    """((dim, axes), ...): the splits of ``fsdp_spec`` that a use of the
    leaf gathers, every one but the experts' over "model" (expert
    parallelism keeps each rank's experts)."""
    spec = fsdp_spec(name, shape, mesh)
    return tuple((d, _axes_of(e)) for d, e in enumerate(spec)
                 if e is not None and not (_is_expert(name) and e == "model"))


def row_axes(mesh, mode: str = "tp") -> tuple[str, ...]:
    """The axes over which ``shard_batch`` splits a training batch's rows:
    the data axes in "tp" mode, every axis in "fsdp" mode."""
    _check_mode(mode)
    return MeshSpec.of(mesh).axis_names if mode == "fsdp" else \
        batch_axes(mesh)


def expert_parallel(name: str, shape, mesh) -> bool:
    """Whether this leaf is an expert weight whose expert dim divides
    "model" (sliced over "model" by ``shard_params`` in both modes)."""
    shape = _shape(shape)
    return _is_expert(name) and shape[-3] % MeshSpec.of(mesh).shape[
        "model"] == 0


def _check_mode(mode: str) -> None:
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding mode {mode!r}: want tp or fsdp")


def leaf_spec(name: str, shape, mesh, mode: str = "tp") -> tuple:
    """The spec by which ``mode`` lays a parameter out: ``param_spec`` in
    "tp" mode, ``fsdp_spec`` in "fsdp" mode.  The one source of the layout
    that ``shard_params``, ``Model.sharded``, the models' gathers, the
    clip's norm and the checkpoint read."""
    _check_mode(mode)
    return fsdp_spec(name, shape, mesh) if mode == "fsdp" else \
        param_spec(name, shape, mesh)


def carried(name: str, shape, mesh, mode: str = "tp") -> bool:
    """Whether ``shard_params`` slices this leaf (``shape`` the whole
    leaf's): whether ``leaf_spec`` splits any dim.  At axes of size 1 a
    split leaf is whole, and counts as split all the same, so that a (1, 1)
    mesh runs the mode's path and its collectives."""
    return bool(spec_axes(leaf_spec(name, shape, mesh, mode)))


def sharded_specs(params: dict, mesh, mode: str = "tp") -> dict:
    """{name: ``leaf_spec``} of the leaves of a flat tree of whole leaves
    (or shapes) that ``carried`` names."""
    return {n: leaf_spec(n, p, mesh, mode) for n, p in params.items()
            if carried(n, p, mesh, mode)}


def shard_params(params: dict, mesh, mode: str = "tp",
                 coord: dict[str, int] | None = None) -> dict:
    """This rank's leaves of a flat tree of whole leaves: each leaf that
    ``carried`` names as its ``leaf_spec`` slice (a contiguous copy), every
    other leaf as it is.  ``coord`` ({axis: index}) names another position
    of ``mesh`` (a DeviceMesh, or a ``MeshSpec`` with ``coord`` given) than
    this process's."""
    coord = coordinate(mesh) if coord is None else coord
    specs = sharded_specs(params, mesh, mode)
    return {n: local_slice(p, specs[n], mesh, coord) if n in specs else p
            for n, p in params.items()}


def split_axes(specs: dict, mesh) -> tuple[tuple, tuple, tuple]:
    """(rows, seq, whole): the axes over which ``batch_shardings``' ``specs``
    of a whole batch put its rows (dim 0) and its sequence (dim 1), each in
    the mesh's order, and the names of the leaves that lie whole on every
    rank beside them.  rows is () where the whole batch lies on every rank;
    seq is () but for an "fsdp" batch smaller than the mesh, whose rows lie
    over a prefix of the axes and whose sequence over the rest.  Every leaf
    the rules split there is split as every other (the same rows, and
    their sequence over the same axes, ``batch_shardings``' first cut that
    divides the rows); a leaf whose second dim no cut divides (whisper's
    1500 frames on 16 ranks of "model") lies whole, rows and all: whole
    names those, () where no leaf is split."""
    mesh = MeshSpec.of(mesh)

    def named(dim: int) -> tuple:
        axes = {a for spec in specs.values() if len(spec) > dim
                for a in _axes_of(spec[dim])}
        return tuple(a for a in mesh.axis_names if a in axes)
    rows, seq = named(0), named(1)
    whole = tuple(k for k, spec in specs.items() if not spec_axes(spec)) \
        if rows or seq else ()
    return rows, seq, whole


def split_batch(batch: dict, mesh, mode: str = "tp"
                ) -> tuple[dict, tuple, tuple, tuple]:
    """(this rank's part of ``batch``, rows, seq, whole) from one
    ``batch_shardings`` of the whole batch in ``mode``: the part as
    ``shard_batch`` cuts it (a leaf that lies whole, whole), the axes its
    rows and its sequence lie over and the leaves that lie whole
    (``split_axes``).  The one source of the split that the steps install
    (``launch/steps.py``, ``Model.on_mesh``)."""
    specs = batch_shardings(batch, mesh, mode)
    coord = coordinate(mesh)
    return ({k: local_slice(v, specs[k], mesh, coord)
             for k, v in batch.items()}, *split_axes(specs, mesh))


def shard_batch(batch: dict, mesh, mode: str = "tp") -> dict:
    """This rank's part of ``batch`` (``batch_shardings`` in ``mode``):
    its rows over the data axes in "tp" mode when the batch divides them,
    else the whole batch, as the reference's expert-parallel blocks take it
    (``repro/models/mlp.py:106-108``); over every axis in "fsdp" mode, or
    the whole batch where no prefix of the axes divides it.  An "fsdp"
    batch smaller than the mesh gives the rank its rows over a prefix of
    the axes and one contiguous slice of their sequence over the rest, in
    ``local_slice``'s order (``split_batch`` gives the axes besides)."""
    return split_batch(batch, mesh, mode)[0]
