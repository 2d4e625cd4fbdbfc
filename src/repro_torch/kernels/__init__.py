"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each with its
plain PyTorch version beside it."""
from __future__ import annotations

import torch


def refuse_grad(message: str, *ts) -> None:
    """Raise ``NotImplementedError(message)`` if grad is enabled and a CUDA
    input requires grad.  A kernel without a backward is a ctypes call that
    autograd cannot see: every parameter upstream of it would silently get
    no gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad and t.device.type == "cuda" for t in ts):
        raise NotImplementedError(message)
