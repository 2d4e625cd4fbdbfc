"""ctypes binding of the CUDA SSD intra-chunk kernel
(``csrc/ssd_intra_chunk.cu``).

The library is built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes
import struct

import torch

from .. import _build

NAME = "ssd_intra_chunk"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
# x, dt, cum, B, C, y, states, C·Bᵀ scratch | dims: dtype, B, NC, L, H, P,
# N, strides of x, dt, cum (4 each), B, C (3 each), packed as int64 | stream
_ARGTYPES = [_P] * 8 + [ctypes.c_char_p, _P]
_DIMS = struct.Struct("<25q")
_TILE = 64        # the scratch holds C·Bᵀ at L rounded up to this
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(NAME)
        lib.ssd_intra_chunk_fwd.argtypes = _ARGTYPES
        lib.ssd_intra_chunk_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ssd_intra_chunk_cuda(xc: torch.Tensor, dtc: torch.Tensor,
                         cum: torch.Tensor, bc: torch.Tensor,
                         cc: torch.Tensor):
    """Launch the C·Bᵀ kernel, then the y and state kernel, on the current
    stream; inputs are already checked by ``ops.ssd_intra_chunk``.  Returns
    (y (B,NC,L,H,P), states (B,NC,H,N,P)), both f32.

    At the served shapes the host's cost of a call is of the order of the
    kernels' time on the card, so it is kept small: sizes and strides go
    packed in one argument, and the stream is read raw."""
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    lp = -(-l // _TILE) * _TILE
    lib = _lib()
    dev = xc.device
    y = torch.empty((b, nc, l, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=dev)
    cb = torch.empty((b * nc, lp, lp), dtype=torch.float32, device=dev)
    dims = _DIMS.pack(_DTYPES[xc.dtype], b, nc, l, h, p, n,
                      *xc.stride()[:4], *dtc.stride(), *cum.stride(),
                      *bc.stride()[:3], *cc.stride()[:3])
    ptrs = (xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(),
            cc.data_ptr(), y.data_ptr(), st.data_ptr(), cb.data_ptr(), dims)
    if dev.index == torch.cuda.current_device():
        err = lib.ssd_intra_chunk_fwd(
            *ptrs, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = lib.ssd_intra_chunk_fwd(
                *ptrs, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, NAME, err)
    return y, st
