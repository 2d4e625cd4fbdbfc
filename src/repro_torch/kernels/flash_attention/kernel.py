"""ctypes bindings of the CUDA flash-attention kernels: the forward
(``csrc/flash_attn_fwd.cu``) and the backward (``csrc/flash_attn_bwd.cu``).

The libraries are built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

NAME = "flash_attn_fwd"
BWD_NAME = "flash_attn_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, o, lse | dtype, B, S, T, H, K, hd | 4 x 3 strides | causal,
# window, scale, stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_LL] * 12 + [_I, _I, ctypes.c_float, _P]
# q, k, v, o, do, lse, delta, dq, dk, dv | dtype, B, S, T, H, K, hd |
# 5 x 3 strides | causal, window, scale, stream
_BWD_ARGTYPES = ([_P] * 10 + [_I] * 7 + [_LL] * 15
                 + [_I, _I, ctypes.c_float, _P])


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.flash_attn_fwd.argtypes = _ARGTYPES
    lib.flash_attn_fwd.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_NAME)
    lib.flash_attn_bwd.argtypes = _BWD_ARGTYPES
    lib.flash_attn_bwd.restype = _I
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, scale: float,
                         with_lse: bool = False):
    """Launch the forward on the current stream; inputs are already checked
    by ``ops``.  Returns o (B,S,H,hd) in q's dtype, and with ``with_lse``
    also the row logsumexp, f32 (B,H,S)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _lib()
    with torch.cuda.device(q.device):
        o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
        lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if with_lse else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, kh, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), int(window), float(scale), stream)
    _build.check(lib, NAME, err)
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool, window: int,
                             scale: float):
    """Launch the backward (three kernels) on the current stream; inputs
    are already checked by ``ops``.  Returns dq, dk, dv, contiguous, in q's
    dtype."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        dk = torch.empty((b, t, kh, hd), dtype=k.dtype, device=k.device)
        dv = torch.empty((b, t, kh, hd), dtype=v.dtype, device=v.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, s, t, h, kh,
            hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], int(causal), int(window),
            float(scale), stream)
    _build.check(lib, BWD_NAME, err)
    return dq, dk, dv
