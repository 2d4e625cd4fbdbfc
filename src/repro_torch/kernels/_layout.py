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
