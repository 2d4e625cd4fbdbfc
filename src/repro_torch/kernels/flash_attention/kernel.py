"""ctypes binding of the CUDA flash-attention kernel (``csrc/flash_attn_fwd.cu``).

The library is built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

NAME = "flash_attn_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, o | dtype, B, S, T, H, K, hd | 4 x 3 strides | causal, window,
# scale, stream
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_LL] * 12 + [_I, _I, ctypes.c_float, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.flash_attn_fwd.argtypes = _ARGTYPES
    lib.flash_attn_fwd.restype = _I
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int,
                         scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream; inputs are already checked
    by ``ops.flash_attention``.  Returns o (B,S,H,hd) in q's dtype."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _lib()
    with torch.cuda.device(q.device):
        o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, kh, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), int(window), float(scale), stream)
    _build.check(lib, NAME, err)
    return o
