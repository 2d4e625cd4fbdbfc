"""Public grouped expert FFN: the CUDA kernels on the card, the plain
versions on the CPU.

The tensor's device decides.  A CUDA tensor launches the hand-written kernel
or raises; nothing falls back to the plain version.  When grad is enabled
and an operand requires grad, the call goes through ``GroupedFFN``, whose
forward saves the operands (no activation: the backward kernel recomputes
the up products) and whose backward is the hand-written backward kernel on
the card (``grouped_ffn_backward_reference`` on the CPU).
``grouped_ffn.launches`` counts forward calls that launched the kernel (one
call is one launch of the up product and one of the down product),
``grouped_ffn.backward_launches`` backward calls that launched the backward
kernel, and nothing else.

A meta tensor (the dry run) gets the CUDA path's outputs, shapes and dtypes,
without arithmetic and without a launch: the launch counts do not move.
Under a ``roofline.counting.Counter`` every call books its
``roofline.kernel_model`` work (the plain version's aten work on the CPU):
over every row, or given ``pairs``, the (token, choice) pairs the caller
routed into buf, over min(pairs, B·E·C) rows and min(E, pairs) experts'
weights, the most those pairs can fill and reach.  A count from shapes
cannot see the routing, which may leave fewer experts live.

The JAX wrapper's ``bf`` (the TPU's F block) has no counterpart: the CUDA
kernels pick their own tiles and mask the ragged edge."""
from __future__ import annotations

import torch

from ...roofline import counting, kernel_model
from .._layout import as_kernel, dense_strides
from .kernel import grouped_ffn_bwd_cuda, grouped_ffn_cuda
from .ref import ACTS, grouped_ffn_backward_reference, grouped_ffn_reference

DTYPES = (torch.float32, torch.bfloat16)


def _operands(buf, w_in, w_gate, w_out, act: str) -> tuple:
    """The tensors the function reads: gelu does not read ``w_gate``."""
    return (buf, w_in, w_gate, w_out) if act == "swiglu" else \
        (buf, w_in, w_out)


def _check_cuda_inputs(buf, w_in, w_gate, w_out, act: str,
                       dy=None) -> None:
    """What the CUDA kernels take; ``dy``, the output's cotangent, for the
    backward."""
    mats = _operands(buf, w_in, w_gate, w_out, act)
    if dy is not None:
        if dy.shape != buf.shape or dy.dtype != buf.dtype or \
                dy.device != buf.device:
            raise ValueError(f"the output's cotangent must match buf: got "
                             f"{tuple(dy.shape)} {dy.dtype} on {dy.device}, "
                             f"buf {tuple(buf.shape)} {buf.dtype} on "
                             f"{buf.device}")
        mats = (*mats, dy)
    if buf.dtype not in DTYPES or any(x.dtype != buf.dtype for x in mats):
        raise TypeError(f"grouped_ffn takes float32 or bfloat16 tensors of "
                        f"one dtype; got {[x.dtype for x in mats]}")
    if buf.dim() != 4 or w_in.dim() != 3 or w_out.dim() != 3:
        raise ValueError(f"want buf (B,E,C,D), w_in (E,D,F), w_out (E,F,D); "
                         f"got {tuple(buf.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(w_out.shape)}")
    b, e, c, d = buf.shape
    f = w_in.shape[-1]
    if w_in.shape != (e, d, f) or w_out.shape != (e, f, d) or (
            act == "swiglu" and w_gate.shape != w_in.shape):
        raise ValueError(f"shapes disagree: buf {tuple(buf.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    if min(b, e, c, d, f) == 0:
        raise ValueError("empty buffer or weights")
    if e > 65535 or b * c >= 2 ** 31:
        raise ValueError("more than 65535 experts or 2^31 rows per expert")
    if any(x.stride(-1) != 1 for x in mats):
        raise ValueError("the last dim of buf and of the weights must be "
                         "contiguous")
    # the bf16 kernel loads rows 16 bytes (8 values) at a time
    if buf.dtype == torch.bfloat16 and (d % 8 or f % 8 or any(
            x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1])
            for x in mats)):
        raise ValueError("bfloat16 rows must start 16-byte aligned: D and F "
                         "multiples of 8, data pointers on 16 bytes, strides "
                         "multiples of 8")


def _fwd(buf, w_in, w_gate, w_out, act: str) -> torch.Tensor:
    """The forward on buf's device: the plain version on the CPU (laid out
    as the kernel's output), an output of buf's shape and dtype on meta,
    the kernel on the card (counted)."""
    if buf.device.type == "cpu":
        return as_kernel(grouped_ffn_reference(buf, w_in, w_gate, w_out, act))
    if buf.is_meta:
        return buf.new_empty(buf.shape)
    _check_cuda_inputs(buf, w_in, w_gate, w_out, act)
    out = grouped_ffn_cuda(buf, w_in, w_gate if act == "swiglu" else w_in,
                           w_out, act)
    grouped_ffn.launches += 1
    return out


def _work(model, buf, w_in, act: str, pairs: int | None):
    """``model``'s (flops, bytes), deferred: over every row of buf, or
    over the rows and experts ``pairs`` routed pairs can fill and reach."""
    b, e, c, _ = buf.shape
    live = {} if pairs is None else {"live_rows": min(pairs, b * e * c),
                                     "live_experts": min(e, pairs)}
    return lambda: model(*buf.shape, w_in.shape[-1], act, buf.dtype, **live)


def _forward(buf, w_in, w_gate, w_out, act: str,
             pairs: int | None = None) -> torch.Tensor:
    """The forward without a graph."""
    if counting.active is None:
        return _fwd(buf, w_in, w_gate, w_out, act)
    return counting.call("moe_gmm", buf.device,
                         _work(kernel_model.moe_gmm, buf, w_in, act, pairs),
                         _fwd, buf, w_in, w_gate, w_out, act)


def _bwd(buf, w_in, w_gate, w_out, dy, act: str):
    """The backward on buf's device: the plain version on the CPU (laid out
    as the kernel's outputs), the gradients' shapes and dtypes on meta, the
    kernel on the card (counted); gelu's w_gate gradient is zeros."""
    if buf.device.type == "cpu":
        return as_kernel(grouped_ffn_backward_reference(
            buf, w_in, w_gate, w_out, dy, act))
    dy = dense_strides(dy.contiguous())
    if buf.is_meta:
        dbuf, dw_in, dw_out = (x.new_empty(x.shape) for x in (buf, w_in,
                                                              w_out))
        dw_gate = w_gate.new_empty(w_gate.shape) if act == "swiglu" else None
    else:
        _check_cuda_inputs(buf, w_in, w_gate, w_out, act, dy)
        dbuf, dw_in, dw_gate, dw_out = grouped_ffn_bwd_cuda(
            buf, w_in, w_gate if act == "swiglu" else w_in, w_out, dy, act)
        grouped_ffn.backward_launches += 1
    if dw_gate is None:
        dw_gate = torch.zeros_like(w_gate)
    return dbuf, dw_in, dw_gate, dw_out


class GroupedFFN(torch.autograd.Function):
    """The grouped expert FFN with a gradient: the forward keeps buf and the
    three weights; the backward is the hand-written kernel on the card
    (deterministic: every sum in a fixed order) and
    ``grouped_ffn_backward_reference`` on the CPU.  For gelu the gradient of
    ``w_gate``, which is not read, is zeros."""

    @staticmethod
    def forward(ctx, buf, w_in, w_gate, w_out, act: str,
                pairs: int | None = None):
        ctx.save_for_backward(buf, w_in, w_gate, w_out)
        ctx.act, ctx.pairs = act, pairs
        return _forward(buf, w_in, w_gate, w_out, act, pairs)

    @staticmethod
    def backward(ctx, dy):
        buf, w_in, w_gate, w_out = ctx.saved_tensors
        args = (buf, w_in, w_gate, w_out, dy, ctx.act)
        if counting.active is None:
            grads = _bwd(*args)
        else:
            grads = counting.call("moe_gmm_bwd", buf.device,
                                  _work(kernel_model.moe_gmm_bwd, buf, w_in,
                                        ctx.act, ctx.pairs),
                                  _bwd, *args)
        return (*grads, None, None)


def grouped_ffn(buf: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
                w_out: torch.Tensor, act: str = "swiglu",
                pairs: int | None = None) -> torch.Tensor:
    """buf (B,E,C,D); w_in/w_gate (E,D,F); w_out (E,F,D) -> (B,E,C,D).

    Per (b, e): silu(X W_gate) * (X W_in) then W_out (swiglu), or
    gelu_tanh(X W_in) W_out (gelu; ``w_gate`` is not read).  f32 sums; the
    output is in buf's dtype.  ``pairs``, the routed (token, choice) pairs
    that buf holds at most, is read by a counter's booking alone."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}; got {act!r}")
    mats = _operands(buf, w_in, w_gate, w_out, act)
    if any(x.device != buf.device for x in mats) or \
            buf.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"buf and the weights must lie on the CPU, on one "
                         f"CUDA device or on meta; got "
                         f"{[str(x.device) for x in mats]}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (buf, w_in, w_gate, w_out)):
        return GroupedFFN.apply(buf, w_in, w_gate, w_out, act, pairs)
    return _forward(buf, w_in, w_gate, w_out, act, pairs)


grouped_ffn.launches = 0
grouped_ffn.backward_launches = 0


__all__ = ["GroupedFFN", "grouped_ffn", "grouped_ffn_backward_reference",
           "grouped_ffn_reference"]
