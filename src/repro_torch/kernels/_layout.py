"""The kernels' output layout for their plain versions' results."""
from __future__ import annotations

import torch


def as_kernel(out):
    """``out`` (a tensor, or a tuple of tensors and Nones) made contiguous,
    as the kernels write their outputs: then the CPU path and the card's run
    the same ops after the call, and count the same work."""
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    return tuple(None if t is None else t.contiguous() for t in out)


def dense_strides(x: torch.Tensor) -> torch.Tensor:
    """A contiguous ``x`` with a contiguous tensor's strides.  PyTorch calls
    a tensor contiguous whatever strides its dims of extent 1 carry (an
    einsum's backward gives a batch of one row the stride 1, so
    ``contiguous()`` keeps it), and the kernels' checks and TMA maps read
    every stride; the same elements, no copy."""
    want, acc = [], 1
    for n in reversed(x.shape):
        want.append(acc)
        acc *= n
    want = tuple(reversed(want))
    return x if x.stride() == want else x.as_strided(x.shape, want)
