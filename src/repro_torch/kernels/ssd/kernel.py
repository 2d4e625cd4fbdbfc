"""ctypes bindings of the CUDA SSD intra-chunk kernels: the forward
(``csrc/ssd_intra_chunk.cu``) and its backward
(``csrc/ssd_intra_chunk_bwd.cu``).

The library is built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes
import struct

import torch

from .. import _build

NAME = "ssd_intra_chunk"
BWD_NAME = "ssd_intra_chunk_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
# x, dt, cum, B, C, y, states, C·Bᵀ scratch | dims: dtype, B, NC, L, H, P,
# N, strides of x, dt, cum (4 each), B, C (3 each), packed as int64 | stream
_ARGTYPES = [_P] * 8 + [ctypes.c_char_p, _P]
_DIMS = struct.Struct("<25q")
# the backward: 15 pointers (x, dt, cum, B, C, dy, dS, dx, d dt, d cum, dB,
# dC, the C·Bᵀ scratch and the dCB and state-term group partials) | the
# forward's dims | stream
_BWD_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_char_p, _P]
_BWD_PTRS = _P * 15
_TILE = 64        # the scratches hold L x L at L rounded up to this
_LIB: ctypes.CDLL | None = None
_BWD_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(NAME)
        lib.ssd_intra_chunk_fwd.argtypes = _ARGTYPES
        lib.ssd_intra_chunk_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load(BWD_NAME)
        lib.ssd_intra_chunk_bwd.argtypes = _BWD_ARGTYPES
        lib.ssd_intra_chunk_bwd.restype = ctypes.c_int
        lib.ssd_bwd_groups.argtypes = [ctypes.c_int]
        lib.groups = (lib.ssd_bwd_groups(0), lib.ssd_bwd_groups(1))
        _BWD_LIB = lib
    return _BWD_LIB


def _dims(xc, dtc, cum, bc, cc) -> bytes:
    """The dtype, sizes and strides both kernels take, packed as int64."""
    b, nc, l, h, p = xc.shape
    return _DIMS.pack(_DTYPES[xc.dtype], b, nc, l, h, p, bc.shape[-1],
                      *xc.stride()[:4], *dtc.stride(), *cum.stride(),
                      *bc.stride()[:3], *cc.stride()[:3])


def _call(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``dev``, read raw."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


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
    err = _call(lib.ssd_intra_chunk_fwd, dev, xc.data_ptr(), dtc.data_ptr(),
                cum.data_ptr(), bc.data_ptr(), cc.data_ptr(), y.data_ptr(),
                st.data_ptr(), cb.data_ptr(), _dims(xc, dtc, cum, bc, cc))
    _build.check(lib, NAME, err)
    return y, st


def ssd_intra_chunk_bwd_cuda(xc: torch.Tensor, dtc: torch.Tensor,
                             cum: torch.Tensor, bc: torch.Tensor,
                             cc: torch.Tensor, dy: torch.Tensor,
                             dstates: torch.Tensor):
    """Launch the backward (C·Bᵀ, the per-head kernel, dCB, then dB and dC)
    on the current stream; inputs and the contiguous f32 cotangents ``dy``
    (B,NC,L,H,P) and ``dstates`` (B,NC,H,N,P) are already checked by
    ``ops.SSDIntraChunk``.  Returns (dxc in xc's dtype, d dtc, d cum, d bc,
    d cc), all contiguous.  The dCB and state-term scratches hold one
    partial per head group of their kernels (the library says how many)."""
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    lp = -(-l // _TILE) * _TILE
    lib = _bwd_lib()
    dev = xc.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, nc, l, h, p), dtype=xc.dtype, device=dev)
    ddt = torch.empty((b, nc, l, h), **f32)
    dcum = torch.empty((b, nc, l, h), **f32)
    dbc = torch.empty((b, nc, l, n), **f32)
    dcc = torch.empty((b, nc, l, n), **f32)
    cb = torch.empty((b * nc, lp, lp), **f32)
    dcb = torch.empty((lib.groups[0], b * nc, lp, lp), **f32)
    dst = torch.empty((lib.groups[1], b * nc, l, n), **f32)
    ptrs = _BWD_PTRS(*(t.data_ptr() for t in (
        xc, dtc, cum, bc, cc, dy, dstates, dx, ddt, dcum, dbc, dcc, cb,
        dcb, dst)))
    err = _call(lib.ssd_intra_chunk_bwd, dev, ptrs,
                _dims(xc, dtc, cum, bc, cc))
    _build.check(lib, BWD_NAME, err)
    return dx, ddt, dcum, dbc, dcc
