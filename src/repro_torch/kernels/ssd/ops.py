"""Public SSD intra-chunk entry: the CUDA kernel on the card, the plain
version on the CPU.

The tensors' device decides.  CUDA tensors launch the hand-written kernel or
raise; nothing falls back to the plain version.  When grad is enabled and an
input requires grad, the call goes through ``SSDIntraChunk``, whose backward
is the hand-written backward kernel on the card (its plain version on the
CPU).  ``ssd_intra_chunk.launches`` counts calls that launched the forward
kernel (one call is one launch of the C·Bᵀ kernel and one of the y and state
kernel) and ``ssd_intra_chunk.backward_launches`` backward calls that
launched the backward kernels, and nothing else.

A meta tensor (the dry run) gets the CUDA path's outputs, shapes and dtypes,
without arithmetic and without a launch: the launch counts do not move.
Under a ``roofline.counting.Counter`` every call books its
``roofline.kernel_model`` work (the plain version's aten work on the CPU).

The JAX wrapper's ``interpret`` flag has no counterpart: the device of the
tensors takes its place."""
from __future__ import annotations

import torch

from ...roofline import counting, kernel_model
from .._layout import as_kernel
from .kernel import ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda
from .ref import (ssd_intra_chunk_backward_reference,
                  ssd_intra_chunk_reference, ssd_reference)

X_DTYPES = (torch.float32, torch.bfloat16)
MAX_L, MAX_N, MAX_P = 256, 128, 64


def _check_cuda_inputs(xc, dtc, cum, bc, cc, dy=None, dstates=None) -> None:
    if xc.dtype not in X_DTYPES or any(
            t.dtype != torch.float32 for t in (dtc, cum, bc, cc)):
        raise TypeError(f"ssd_intra_chunk takes xc in float32 or bfloat16 "
                        f"and dtc, cum, bc, cc in float32; got "
                        f"{[str(t.dtype) for t in (xc, dtc, cum, bc, cc)]}")
    if xc.dim() != 5 or dtc.dim() != 4 or bc.dim() != 4:
        raise ValueError(f"want xc (B,NC,L,H,P), dtc/cum (B,NC,L,H), bc/cc "
                         f"(B,NC,L,N); got {tuple(xc.shape)}, "
                         f"{tuple(dtc.shape)}, {tuple(bc.shape)}")
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    if dtc.shape != (b, nc, l, h) or cum.shape != dtc.shape or \
            bc.shape != (b, nc, l, n) or cc.shape != bc.shape:
        raise ValueError(f"shapes disagree: xc {tuple(xc.shape)}, dtc "
                         f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}, bc "
                         f"{tuple(bc.shape)}, cc {tuple(cc.shape)}")
    if min(b, nc, l, h, p, n) == 0:
        raise ValueError("empty input")
    if l > MAX_L or n > MAX_N or p > MAX_P:
        raise ValueError(f"the kernel takes L <= {MAX_L}, N <= {MAX_N} and "
                         f"P <= {MAX_P}; got L {l}, N {n}, P {p}")
    if b * nc > 65535 or h > 65535:
        raise ValueError("more than 65535 batch rows x chunks or heads")
    if any(t.stride(-1) != 1 for t in (xc, bc, cc)):
        raise ValueError("the last dim of xc, bc and cc must be contiguous")
    for name, t, shape in (("dy", dy, (b, nc, l, h, p)),
                           ("dstates", dstates, (b, nc, h, n, p))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != xc.device
                              or not t.is_contiguous()):
            raise ValueError(f"the cotangent {name} must be contiguous f32 "
                             f"{shape} on {xc.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _fwd(xc, dtc, cum, bc, cc):
    """The forward on xc's device: the plain version on the CPU (laid out as
    the kernel's outputs), the outputs' shapes (f32) on meta, the kernel on
    the card (counted)."""
    if xc.device.type == "cpu":
        return as_kernel(ssd_intra_chunk_reference(xc, dtc, cum, bc, cc))
    if xc.is_meta:
        b, nc, l, h, p = xc.shape
        n = bc.shape[-1]
        return (xc.new_empty((b, nc, l, h, p), dtype=torch.float32),
                xc.new_empty((b, nc, h, n, p), dtype=torch.float32))
    _check_cuda_inputs(xc, dtc, cum, bc, cc)
    out = ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc)
    ssd_intra_chunk.launches += 1
    return out


def _work(model, xc, bc):
    """``model``'s (flops, bytes) at these inputs, deferred."""
    return lambda: model(*xc.shape, bc.shape[-1], xc.dtype)


def _forward(xc, dtc, cum, bc, cc):
    """The forward without a graph."""
    if counting.active is None:
        return _fwd(xc, dtc, cum, bc, cc)
    return counting.call("ssd_intra_chunk", xc.device,
                         _work(kernel_model.ssd, xc, bc), _fwd, xc, dtc, cum,
                         bc, cc)


def _bwd(xc, dtc, cum, bc, cc, dy, dstates):
    """The backward on xc's device: the plain version on the CPU (which
    skips an absent cotangent's terms; laid out as the kernel's outputs);
    elsewhere an absent cotangent is zeros, and meta gets the gradients'
    shapes (dxc in xc's dtype, the rest f32), the card the kernel
    (counted)."""
    if xc.device.type == "cpu":
        return as_kernel(ssd_intra_chunk_backward_reference(
            xc, dtc, cum, bc, cc, dy, dstates))
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    f32 = torch.float32
    dy = (xc.new_zeros((b, nc, l, h, p), dtype=f32) if dy is None
          else dy.contiguous())
    dstates = (xc.new_zeros((b, nc, h, n, p), dtype=f32)
               if dstates is None else dstates.contiguous())
    if xc.is_meta:
        return (xc.new_empty(xc.shape),
                *(t.new_empty(t.shape, dtype=f32) for t in (dtc, cum, bc, cc)))
    _check_cuda_inputs(xc, dtc, cum, bc, cc, dy, dstates)
    grads = ssd_intra_chunk_bwd_cuda(xc, dtc, cum, bc, cc, dy, dstates)
    ssd_intra_chunk.backward_launches += 1
    return grads


class SSDIntraChunk(torch.autograd.Function):
    """The SSD intra-chunk function with a gradient: the forward keeps its
    five inputs (not M or C·Bᵀ, which the backward recomputes); the backward
    is the hand-written kernel on the card (deterministic: every sum over
    heads and rows in a fixed order) and
    ``ssd_intra_chunk_backward_reference`` on the CPU.  A cotangent that
    does not reach the function arrives as None: the plain version skips
    its terms, the kernel takes zeros."""

    @staticmethod
    def forward(ctx, xc, dtc, cum, bc, cc):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xc, dtc, cum, bc, cc)
        return _forward(xc, dtc, cum, bc, cc)

    @staticmethod
    def backward(ctx, dy, dstates):
        xc, dtc, cum, bc, cc = ctx.saved_tensors
        if dy is None and dstates is None:
            return None, None, None, None, None
        args = (xc, dtc, cum, bc, cc, dy, dstates)
        if counting.active is None:
            return _bwd(*args)
        return counting.call("ssd_intra_chunk_bwd", xc.device,
                             _work(kernel_model.ssd_bwd, xc, bc), _bwd, *args)


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                    bc: torch.Tensor, cc: torch.Tensor):
    """xc (B,NC,L,H,P), dtc/cum (B,NC,L,H), bc/cc (B,NC,L,N) ->
    (y_intra (B,NC,L,H,P) f32, states (B,NC,H,N,P) f32); see
    ``ssd_intra_chunk_reference`` for the function."""
    ts = (xc, dtc, cum, bc, cc)
    if any(t.device != xc.device for t in ts) or \
            xc.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the inputs must lie on the CPU, on one CUDA "
                         f"device or on meta; got "
                         f"{[str(t.device) for t in ts]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SSDIntraChunk.apply(*ts)
    return _forward(*ts)


ssd_intra_chunk.launches = 0
ssd_intra_chunk.backward_launches = 0


__all__ = ["SSDIntraChunk", "ssd_intra_chunk",
           "ssd_intra_chunk_backward_reference", "ssd_intra_chunk_reference",
           "ssd_reference"]
