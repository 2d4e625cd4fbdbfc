"""ctypes binding of the CUDA SSD intra-chunk kernel
(``csrc/ssd_intra_chunk.cu``).

The library is built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

NAME = "ssd_intra_chunk"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, dt, cum, B, C, y, states | dtype, B, NC, L, H, P, N |
# x, dt, cum 4 strides each, B, C 3 each | stream
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_LL] * 18 + [_P]


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.ssd_intra_chunk_fwd.argtypes = _ARGTYPES
    lib.ssd_intra_chunk_fwd.restype = _I
    return lib


def ssd_intra_chunk_cuda(xc: torch.Tensor, dtc: torch.Tensor,
                         cum: torch.Tensor, bc: torch.Tensor,
                         cc: torch.Tensor):
    """Launch the y and state kernels on the current stream; inputs are
    already checked by ``ops.ssd_intra_chunk``.  Returns (y (B,NC,L,H,P),
    states (B,NC,H,N,P)), both f32."""
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    lib = _lib()
    with torch.cuda.device(xc.device):
        y = torch.empty((b, nc, l, h, p), dtype=torch.float32,
                        device=xc.device)
        st = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                         device=xc.device)
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.ssd_intra_chunk_fwd(
            xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(),
            cc.data_ptr(), y.data_ptr(), st.data_ptr(), _DTYPES[xc.dtype],
            b, nc, l, h, p, n, *xc.stride()[:4],
            *dtc.stride(), *cum.stride(), *bc.stride()[:3],
            *cc.stride()[:3], stream)
    _build.check(lib, NAME, err)
    return y, st
