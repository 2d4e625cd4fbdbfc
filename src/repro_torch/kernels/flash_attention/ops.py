"""Public flash-attention entry: the CUDA kernels on the card, the plain
versions on the CPU.

The tensor's device decides.  A CUDA tensor launches the hand-written kernel
or raises; nothing falls back to the plain version.  When grad is enabled
and an input requires grad, the call goes through ``FlashAttention``, whose
forward also keeps each row's logsumexp and whose backward is the
hand-written backward kernel on the card (its plain version on the CPU);
otherwise the forward launches without the logsumexp, as serving does.
``flash_attention.launches`` counts forward launches and
``flash_attention.backward_launches`` backward calls (and nothing else), so
a run can show that its path went through the kernels.

A meta tensor (the dry run) gets the CUDA path's outputs, shapes and dtypes
(``lse`` included), without arithmetic and without a launch: the launch
counts do not move.  Under a ``roofline.counting.Counter`` every call books
its ``roofline.kernel_model`` work (the plain version's aten work on the
CPU)."""
from __future__ import annotations

import torch

from ...roofline import counting, kernel_model
from .._layout import as_kernel, dense_strides
from .kernel import (TMA_HEAD_DIMS, flash_attention_bwd_cuda,
                     flash_attention_cuda)
from .ref import attention_backward_reference, attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)   # bf16 at 16, 32, 80 on mma.sync
DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_inputs(q, k, v, do=None) -> None:
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k, v (B,T,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    bk, t, kh, hdk = k.shape
    if bk != b or hdk != hd:
        raise ValueError(f"batch or head dim differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if s == 0 or t == 0:
        raise ValueError("empty sequence")
    if h > 65535 or b > 65535:
        raise ValueError("more than 65535 heads or batch rows")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype
                           or do.device != q.device):
        raise ValueError(f"the output's cotangent must match q: got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}, q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    rows = (q, k, v) if do is None else (q, k, v, do)
    if any(x.stride(-1) != 1 for x in rows):
        raise ValueError("the last dim of q, k, v and do must be contiguous")
    # the bf16 kernels load rows 16 bytes (8 values) at a time
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])
            for x in rows):
        raise ValueError("bfloat16 q, k, v and do rows must start 16-byte "
                         "aligned: data pointers on 16 bytes, strides "
                         "multiples of 8")
    # at hd 64 and 128 the bf16 forward and backward load tiles through TMA
    # tensor maps, which take strides above 0 and below 2^40 bytes (a dim of
    # extent 1 is never stepped, so its stride does not matter)
    if q.dtype == torch.bfloat16 and hd in TMA_HEAD_DIMS and any(
            n > 1 and not 0 < st < 2 ** 39
            for x in rows for n, st in zip(x.shape[:3], x.stride()[:3])):
        raise ValueError("bfloat16 q, k, v and do at hd 64 and 128 are read "
                         "through TMA: every stride of a dim longer than 1 "
                         "must be above 0 and below 2^40 bytes")


def _fwd(q, k, v, causal: bool, window: int, scale: float,
         with_lse: bool):
    """The forward on q's device: the plain version on the CPU (laid out as
    the kernel's outputs); on meta the kernel's outputs, o (B,S,H,hd) in q's
    dtype and with ``with_lse`` the f32 row logsumexp (B,H,S); on the card
    the kernel, its inputs checked and its launch counted."""
    if q.device.type == "cpu":
        return as_kernel(attention_reference(
            q, k, v, causal=causal, window=window, scale=scale,
            return_lse=with_lse))
    if q.is_meta:
        b, s, h, _ = q.shape
        o = q.new_empty(q.shape)
        return (o, q.new_empty((b, h, s), dtype=torch.float32)) \
            if with_lse else o
    _check_cuda_inputs(q, k, v)
    out = flash_attention_cuda(q, k, v, causal, window, scale,
                               with_lse=with_lse)
    flash_attention.launches += 1
    return out


def _forward(q, k, v, causal: bool, window: int, scale: float,
             with_lse: bool = False):
    if counting.active is None:
        return _fwd(q, k, v, causal, window, scale, with_lse)
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    return counting.call(
        "flash_attn_fwd", q.device,
        lambda: kernel_model.flash_fwd(b, s, t, h, kh, hd, causal, window,
                                       q.dtype, with_lse),
        _fwd, q, k, v, causal, window, scale, with_lse)


def _bwd(q, k, v, o, lse, do, causal: bool, window: int, scale: float):
    """The backward on q's device: the plain version on the CPU (laid out
    as the kernel's outputs); on meta dq, dk, dv of the inputs' shapes and
    dtypes, contiguous as the kernel's; on the card the kernel, its inputs
    checked and its call counted."""
    if q.device.type == "cpu":
        return as_kernel(attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, window=window, scale=scale))
    do = dense_strides(do.contiguous())
    if q.is_meta:
        return tuple(x.new_empty(x.shape) for x in (q, k, v))
    _check_cuda_inputs(q, k, v, do)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window,
                                     scale)
    flash_attention.backward_launches += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward keeps q, k, v, o and the
    row logsumexp; the backward is the hand-written kernel on the card and
    ``attention_backward_reference`` on the CPU.  Causal attention with
    fewer keys than queries is refused on both devices: rows without a key
    have no gradient that the kernel and the plain version agree on."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        if causal and k.shape[1] < q.shape[1]:
            raise ValueError("causal attention with fewer keys than queries "
                             "leaves rows without a key")
        o, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.attn
        args = (q, k, v, o, lse, do, causal, window, scale)
        if counting.active is None:
            dq, dk, dv = _bwd(*args)
        else:
            b, s, h, hd = q.shape
            t, kh = k.shape[1], k.shape[2]
            dq, dk, dv = counting.call(
                "flash_attn_bwd", q.device,
                lambda: kernel_model.flash_bwd(b, s, t, h, kh, hd, causal,
                                               window, q.dtype),
                _bwd, *args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).

    Causal masking uses the diagonal offset T - S; ``window > 0`` keeps the
    last ``window`` keys of each row.  ``scale`` defaults to hd^-0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not (q.device == k.device == v.device) or \
            q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"q, k, v must lie on the CPU, on one CUDA device "
                         f"or on meta; got {q.device}, {k.device}, "
                         f"{v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


flash_attention.launches = 0
flash_attention.backward_launches = 0


__all__ = ["FlashAttention", "attention_backward_reference",
           "attention_reference", "flash_attention"]
