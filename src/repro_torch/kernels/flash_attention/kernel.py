"""ctypes bindings of the CUDA flash-attention kernels: the forward
(``csrc/flash_attn_fwd.cu``) and the backward (``csrc/flash_attn_bwd.cu``),
and the backward's band schedule.

The libraries are built at the first call (``kernels/_build.py``); importing
this module needs neither ``nvcc`` nor a card."""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from .. import _build

NAME = "flash_attn_fwd"
BWD_NAME = "flash_attn_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, o, lse | dtype, B, S, T, H, K, hd | 4 x 3 strides | causal,
# window, scale, stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_LL] * 12 + [_I, _I, ctypes.c_float, _P]
# q, k, v, o, do, lse, dq, dk, dv, workspace, schedule | dims (26 int64:
# dtype, body, B, S, T, H, K, hd, causal, window, SMs, 5 x 3 strides) |
# scale, stream
_BWD_ARGTYPES = [_P] * 11 + [ctypes.c_char_p, ctypes.c_float, _P]
_BWD_DIMS = struct.Struct("<26q")
# the backward's bodies (csrc/flash_attn_bwd.cu: kBodyFma, kBodyMma,
# kBodyWgmma) and the wgmma body's tiles (wg::kBlockKV, wg::kBlockQ)
BODIES = {"fma": 0, "mma": 1, "wgmma": 2}
BWD_TILE_KV, BWD_TILE_Q = 128, 64
# bf16 head dims whose tiles go through TMA into wgmma, forward and backward
TMA_HEAD_DIMS = (64, 128)
_BWD_LIB: ctypes.CDLL | None = None
_SCHEDULES: dict[tuple, torch.Tensor] = {}
_SMS: dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    lib.flash_attn_fwd.argtypes = _ARGTYPES
    lib.flash_attn_fwd.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load(BWD_NAME)
        lib.flash_attn_bwd.argtypes = _BWD_ARGTYPES
        lib.flash_attn_bwd.restype = _I
        _BWD_LIB = lib
    return _BWD_LIB


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


def band_schedule(b: int, s: int, t: int, kh: int, causal: bool,
                  window: int) -> np.ndarray:
    """The wgmma backward's band schedule, from the shape alone, as one
    int32 array the kernel reads:

    * ``items`` (n_kv * B * K): the work items in ticket order, each
      ``(n * B + b) * K + kh`` for kv tile n (of 128 rows), batch b and kv
      head kh; kv-tile-major, so an item's predecessors on every q tile
      (the lower kv tiles of its (b, kh)) hold lower tickets, and the
      heaviest causal tiles come first;
    * ``q_lo``, ``q_hi`` (n_kv each): the q tiles (of 64 rows) that kv tile
      n walks, [q_lo, q_hi): those with a row that keeps a key of the tile;
    * ``first``, ``count`` (n_q each): the lowest kv tile that adds to q
      tile t and the number that do.  An item's add to tile t has rank
      ``n - first[t]``; the last, rank ``count[t] - 1``, writes dq.

    Causal masking uses the diagonal offset T - S; ``window > 0`` keeps the
    last ``window`` keys of each row (ref.py::_scores)."""
    n_kv, n_q = -(-t // BWD_TILE_KV), -(-s // BWD_TILE_Q)
    diag = t - s
    k0 = np.arange(n_kv) * BWD_TILE_KV
    k1 = np.minimum(k0 + BWD_TILE_KV, t) - 1          # last key of a tile
    # the rows that see some key of the tile form the interval [lo, hi)
    lo = np.maximum(0, k0 - diag) if causal else np.zeros(n_kv, np.int64)
    hi = (np.minimum(s, k1 - diag + window) if window > 0
          else np.full(n_kv, s))
    empty = hi <= lo
    q_lo = np.where(empty, 0, lo // BWD_TILE_Q)
    q_hi = np.where(empty, 0, -(-hi // BWD_TILE_Q))
    seen = ((q_lo[:, None] <= np.arange(n_q))
            & (np.arange(n_q) < q_hi[:, None]))            # (n_kv, n_q)
    count = seen.sum(0)
    first = np.argmax(seen, axis=0)
    if (count == 0).any():
        raise ValueError(f"q tiles {np.flatnonzero(count == 0).tolist()} "
                         f"see no key")
    items = np.arange(n_kv * b * kh)          # (n * B + b) * K + kh
    return np.concatenate([items, q_lo, q_hi, first, count]).astype(np.int32)


def _schedule(dev: torch.device, *shape) -> torch.Tensor:
    key = (dev, *shape)
    sched = _SCHEDULES.get(key)
    if sched is None:
        sched = torch.from_numpy(band_schedule(*shape)).to(dev)
        _SCHEDULES[key] = sched
    return sched


def bwd_body(dtype: torch.dtype, hd: int, body: str | None = None) -> str:
    """The backward's body for ``dtype`` and ``hd``: FMAs in f32; in bf16
    wgmma at hd 64 and 128, mma.sync at hd 16, 32 and 80.  ``body="mma"``
    asks for the mma.sync body at hd 128 too (to time the two in turns)."""
    if dtype == torch.float32:
        want = "fma"
    else:
        want = "wgmma" if hd in TMA_HEAD_DIMS else "mma"
    if body is None or body == want:
        return want
    if body == "mma" and dtype == torch.bfloat16 and hd == 128:
        return body
    raise ValueError(f"no {body} body of the backward for {dtype} at hd {hd}")


def workspace_words(b: int, s: int, h: int, hd: int, body: str) -> int:
    """f32 words of the backward's workspace (flash_attn_bwd.cu): D, and for
    the wgmma body lse * log2 e, the dq sums and the int32 counters."""
    rows = b * h * -(-s // BWD_TILE_Q) * BWD_TILE_Q
    if body != "wgmma":
        return rows
    return 2 * rows + b * h * s * hd + b * h * -(-s // BWD_TILE_Q) + 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool, window: int,
                             scale: float, body: str | None = None):
    """Launch the backward on the current stream; inputs are already
    checked by ``ops``.  Returns dq, dk, dv, contiguous, in q's dtype.
    ``body`` picks a body other than the default (``bwd_body``).

    The host's cost of a call is kept small: sizes and strides go packed
    in one argument, the stream is read raw, and the schedule is cached per
    shape."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    body = bwd_body(q.dtype, hd, body)
    lib = _bwd_lib()
    dev = q.device
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    ws = torch.empty(workspace_words(b, s, h, hd, body), dtype=torch.float32,
                     device=dev)
    dq = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((b, t, kh, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((b, t, kh, hd), dtype=v.dtype, device=dev)
    sched = (_schedule(dev, b, s, t, kh, bool(causal), int(window))
             if body == "wgmma" else None)
    dims = _BWD_DIMS.pack(
        _DTYPES[q.dtype], BODIES[body], b, s, t, h, kh, hd, int(causal),
        int(window), sms, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ws.data_ptr(),
            None if sched is None else sched.data_ptr(), dims, float(scale))
    if dev.index == torch.cuda.current_device():
        err = lib.flash_attn_bwd(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = lib.flash_attn_bwd(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, BWD_NAME, err)
    return dq, dk, dv
