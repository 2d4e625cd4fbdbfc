"""The weights of a run, drawn on the device from ``--seed``: each leaf of
``reference.leaf_specs`` from a generator of its own (so that one leaf can
be drawn again alone), in float32 slices of up to 2^26 values cast into
the leaf's dtype.  Both sides are handed these tensors: the program
through ``Model.load_state``, the reference directly."""
from __future__ import annotations

import torch

from .common import sub_seed
from .reference import dtype_of, leaf_specs

_CHUNK = 1 << 26


def draw_leaf(spec, seed: int, name: str, device) -> torch.Tensor:
    shape, dtype, init = spec
    out = torch.empty(shape, dtype=dtype_of(dtype), device=device)
    kind = init[0]
    if kind == "zeros":
        return out.zero_()
    if kind != "normal":
        raise ValueError(f"{name}: unknown init {init}")
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights", name))
    flat = out.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        part = flat[i:i + _CHUNK]
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32).mul_(init[1]))
    return out


def draw(arch, seed: int, device) -> dict:
    """{leaf name: tensor} of every leaf of ``arch``'s tree."""
    return {name: draw_leaf(spec, seed, name, device)
            for name, spec in leaf_specs(arch).items()}
