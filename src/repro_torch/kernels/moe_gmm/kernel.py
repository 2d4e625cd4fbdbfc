"""ctypes bindings of the CUDA grouped expert FFN (``csrc/moe_gmm.cu``) and
of its backward (``csrc/moe_gmm_bwd.cu``), and the backward's body choice
and TMA maps.

The libraries are built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes
import struct

import torch

from .. import _build

NAME = "moe_gmm"
BWD_NAME = "moe_gmm_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"swiglu": 1, "gelu": 2}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# buf, w_in, w_gate, w_out, h, part, ws, out | dtype, act, B, E, C, D, F |
# buf 3 strides, 3 x 2 weight strides, out 3 strides | stream
_ARGTYPES = [_P] * 8 + [_I] * 7 + [_LL] * 12 + [_P]
# buf, w_in, w_gate, w_out, dy, h, da, dg, ws, dbuf, dw_in, dw_gate, dw_out |
# dims: dtype, act, B, E, C, D, F, strides of buf, dy (3 each), w_in,
# w_gate, w_out (2 each), dbuf (3), body, then BWD_TENSORS' maps (4 dims, 3
# strides each), packed as int64 | stream
_BWD_ARGTYPES = [_P] * 13 + [ctypes.c_char_p, _P]
# the backward's bodies (csrc/moe_gmm_bwd.cu: kBodyFma, kBodyWgmma; the
# kernel refuses a body its dtype does not run)
BWD_BODIES = {"fma": 0, "wgmma": 1}
# the tensors whose TMA maps the wrapper describes, in the kernel's order
# (wg::kMapX ...): the scratch's map serves H, dA and dG
BWD_TENSORS = ("x", "dy", "w_in", "w_gate", "w_out", "scratch", "dw_in",
               "dw_gate", "dw_out")
_BWD_DIMS = struct.Struct(f"<{23 + 7 * len(BWD_TENSORS)}q")


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.moe_gmm_fwd.argtypes = _ARGTYPES
    lib.moe_gmm_fwd.restype = _I
    lib.moe_gmm_partial_floats.argtypes = [_I, _I, _I]
    lib.moe_gmm_partial_floats.restype = _LL
    return lib


def grouped_ffn_cuda(buf: torch.Tensor, w_in: torch.Tensor,
                     w_gate: torch.Tensor, w_out: torch.Tensor,
                     act: str) -> torch.Tensor:
    """Launch the scan and the up and down products on the current stream;
    inputs are already checked by ``ops.grouped_ffn``.  Returns (B,E,C,D) in
    buf's dtype: zero-filled here, so the rows of experts the scan finds
    dead stay exact zeros."""
    b, e, c, d = buf.shape
    f = w_in.shape[-1]
    lib = _lib()
    dev = buf.device
    with torch.cuda.device(dev):
        h = torch.empty((e, b * c, f), dtype=buf.dtype, device=dev)
        part = torch.empty(max(1, lib.moe_gmm_partial_floats(b * c, d, f)),
                           dtype=torch.float32, device=dev)
        ws = torch.zeros(2 + 2 * e, dtype=torch.int32, device=dev)
        out = torch.zeros((b, e, c, d), dtype=buf.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.moe_gmm_fwd(
            buf.data_ptr(), w_in.data_ptr(), w_gate.data_ptr(),
            w_out.data_ptr(), h.data_ptr(), part.data_ptr(), ws.data_ptr(),
            out.data_ptr(),
            _DTYPES[buf.dtype], _ACTS[act], b, e, c, d, f,
            buf.stride(0), buf.stride(1), buf.stride(2),
            *w_in.stride()[:2], *w_gate.stride()[:2], *w_out.stride()[:2],
            out.stride(0), out.stride(1), out.stride(2), stream)
    _build.check(lib, NAME, err)
    return out


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_NAME)
    lib.moe_gmm_bwd.argtypes = _BWD_ARGTYPES
    lib.moe_gmm_bwd.restype = _I
    return lib


def bwd_body(dtype: torch.dtype) -> str:
    """The backward's body for ``dtype``: FMAs in f32; in bf16 wgmma fed by
    TMA, which takes every shape the wrapper does (D and F multiples of 8,
    rows 16-byte aligned: the strides TMA needs).  The choice is by dtype
    alone, never by a failure."""
    return "fma" if dtype == torch.float32 else "wgmma"


def bwd_maps(shape, strides: dict) -> dict:
    """The TMA maps of the wgmma body, from the shape (B, E, C, D, F) and
    the element strides of each tensor (``strides[name]``: the tensor's
    ``stride()``): BWD_TENSORS -> (dims, strides), rank 4, dims inner
    first, the strides of dims 1..3 in elements.  Row operands are cut per
    batch row, so that a box of rows stays in one: buf and dy (cols, C, E,
    B), the (E, B*C, F) scratch (F, C, B, E); weights and their gradients
    are (cols, rows, E, 1).  A dim of extent 1 gets stride 0 here (the
    kernel gives it one that TMA takes; it is never stepped)."""
    b, e, c, d, f = shape

    def rows(name, cols):          # a (B, E, C, cols) tensor
        sb, se, sc = strides[name][:3]
        return (cols, c, e, b), (sc, se, sb)

    def weight(name, n_rows, cols):            # (E, rows, cols)
        se, sr = strides[name][:2]
        return (cols, n_rows, e, 1), (sr, se, 0)

    out = {"x": rows("x", d), "dy": rows("dy", d),
           "w_in": weight("w_in", d, f), "w_gate": weight("w_gate", d, f),
           "w_out": weight("w_out", f, d),
           # (E, B*C, F): row b C + c of expert e at (e B C + b C + c) F
           "scratch": ((f, c, b, e), (f, c * f, b * c * f)),
           "dw_in": ((f, d, e, 1), (f, d * f, 0)),
           "dw_gate": ((f, d, e, 1), (f, d * f, 0)),
           "dw_out": ((d, f, e, 1), (d, f * d, 0))}
    return {name: out[name] for name in BWD_TENSORS}


def grouped_ffn_bwd_cuda(buf: torch.Tensor, w_in: torch.Tensor,
                         w_gate: torch.Tensor, w_out: torch.Tensor,
                         dy: torch.Tensor, act: str):
    """Launch the scan and the hidden, dX and weight-gradient passes on the
    current stream; inputs are already checked by ``ops``.  Returns (dbuf,
    dw_in, dw_gate, dw_out) in buf's dtype.  dbuf is zero-filled here, so
    the rows of experts the scan finds dead stay exact zeros; the kernel
    writes every tile of the weight gradients, dead experts' as zeros.  For
    gelu ``w_gate`` is not read (pass any (E, D, F) tensor, such as w_in)
    and dw_gate is None.  Counts the launch in ``grouped_ffn_bwd_cuda.bodies``
    under the body it names to the kernel (``bwd_body``), which runs that
    body or fails."""
    b, e, c, d = buf.shape
    f = w_in.shape[-1]
    body = bwd_body(buf.dtype)
    lib = _bwd_lib()
    dev = buf.device
    with torch.cuda.device(dev):
        scratch = [torch.empty((e, b * c, f), dtype=buf.dtype, device=dev)
                   for _ in range(3 if act == "swiglu" else 2)]
        ws = torch.zeros(2 + 2 * e, dtype=torch.int32, device=dev)
        dbuf = torch.zeros((b, e, c, d), dtype=buf.dtype, device=dev)
        dw_in = torch.empty((e, d, f), dtype=buf.dtype, device=dev)
        dw_out = torch.empty((e, f, d), dtype=buf.dtype, device=dev)
        dw_gate = (torch.empty((e, d, f), dtype=buf.dtype, device=dev)
                   if act == "swiglu" else None)
        maps = bwd_maps((b, e, c, d, f), {
            "x": buf.stride(), "dy": dy.stride(), "w_in": w_in.stride(),
            "w_gate": w_gate.stride(), "w_out": w_out.stride()})
        dims = _BWD_DIMS.pack(_DTYPES[buf.dtype], _ACTS[act], b, e, c, d, f,
                              *buf.stride()[:3], *dy.stride()[:3],
                              *w_in.stride()[:2], *w_gate.stride()[:2],
                              *w_out.stride()[:2], *dbuf.stride()[:3],
                              BWD_BODIES[body],
                              *(v for dims_, st in maps.values()
                                for v in (*dims_, *st)))
        h, da = scratch[:2]
        dg = scratch[2] if act == "swiglu" else h
        err = lib.moe_gmm_bwd(
            buf.data_ptr(), w_in.data_ptr(), w_gate.data_ptr(),
            w_out.data_ptr(), dy.data_ptr(), h.data_ptr(), da.data_ptr(),
            dg.data_ptr(), ws.data_ptr(), dbuf.data_ptr(), dw_in.data_ptr(),
            dw_in.data_ptr() if dw_gate is None else dw_gate.data_ptr(),
            dw_out.data_ptr(), dims,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, BWD_NAME, err)
    bodies = grouped_ffn_bwd_cuda.bodies
    bodies[body] = bodies.get(body, 0) + 1
    return dbuf, dw_in, dw_gate, dw_out


grouped_ffn_bwd_cuda.bodies = {}
