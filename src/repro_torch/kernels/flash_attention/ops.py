"""Public flash-attention entry: the CUDA kernel on the card, the plain
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the hand-written kernel
or raises; nothing falls back to the plain version.  ``flash_attention.
launches`` counts kernel launches (and nothing else), so a run can show that
its path went through the kernel."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)
TMA_HEAD_DIMS = (64, 128)       # bf16 on wgmma + TMA; 16, 32, 80 on mma.sync
DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_inputs(q, k, v) -> None:
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
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dim of q, k, v must be contiguous")
    # the bf16 kernel loads rows 16 bytes (8 values) at a time
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])
            for x in (q, k, v)):
        raise ValueError("bfloat16 q, k, v rows must start 16-byte aligned: "
                         "data pointers on 16 bytes, strides multiples of 8")
    # at hd 64 and 128 the bf16 kernel loads tiles through TMA tensor maps,
    # which take strides above 0 and below 2^40 bytes (a dim of extent 1 is
    # never stepped, so its stride does not matter)
    if q.dtype == torch.bfloat16 and hd in TMA_HEAD_DIMS and any(
            n > 1 and not 0 < st < 2 ** 39
            for x in (q, k, v) for n, st in zip(x.shape[:3], x.stride()[:3])):
        raise ValueError("bfloat16 q, k, v at hd 64 and 128 are read through "
                         "TMA: every stride of a dim longer than 1 must be "
                         "above 0 and below 2^40 bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).

    Causal masking uses the diagonal offset T - S; ``window > 0`` keeps the
    last ``window`` keys of each row.  ``scale`` defaults to hd^-0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not (q.device == k.device == v.device) or \
            q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must lie on the CPU or on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check_cuda_inputs(q, k, v)
    out = flash_attention_cuda(q, k, v, causal, window, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


__all__ = ["flash_attention", "attention_reference"]
