"""The work of each hand-written kernel, from its shapes and dtypes alone.

Each function returns (flops, bytes): the operations the kernel's function
needs (2 a multiply-add, in the products; the elementwise work beside them
is not counted, as ``torch.utils.flop_counter`` counts none) and the bytes
it must move, each input read once and each output written once.  Where
the kernel skips work by its mask (the causal band, a window), the count
is the kept (query, key) pairs; elsewhere it is the full shape.  The kernel
wrappers book these through ``counting.record_kernel`` at every launch and
every meta call, and ``chip_smoke.py`` divides them by the H100's peaks
for each kernel's bound.

The grouped FFN also takes the live rows and live experts of one buffer,
which only its data shows: the served-decode bound counts those; the dry
run and a step's count take every row.

This replaces the reference's ``roofline/kernel_model.py``, which estimates
what the flash kernel saves from compiled HLO because Pallas cannot lower
on the CPU; the port counts each kernel's own work instead.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: row i (of s) sees keys up to
    i + t - s when causal, and only the last ``window`` of those when
    ``window > 0`` (the kernels' and the plain version's mask)."""
    total = 0
    for i in range(s):
        diag = i + t - s
        hi = min(diag, t - 1) if causal else t - 1
        lo = max(diag - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_fwd(b, s, t, h, k, hd, causal: bool = True, window: int = 0,
              dtype=torch.bfloat16, with_lse: bool = False):
    """softmax(q kᵀ) v: q·kᵀ and p·v over the kept pairs; q, k, v read, o
    written (and the f32 row logsumexp, when the forward keeps it)."""
    flops = 4 * b * h * attention_pairs(s, t, causal, window) * hd
    nbytes = dtype.itemsize * (2 * b * s * h * hd + 2 * b * t * k * hd)
    if with_lse:
        nbytes += 4 * b * h * s
    return flops, nbytes


def flash_bwd(b, s, t, h, k, hd, causal: bool = True, window: int = 0,
              dtype=torch.bfloat16):
    """The backward's five products over the kept pairs (S and P recomputed,
    dV, dP, dQ, dK); q, o, do, dq (B,S,H,hd) and k, v, dk, dv (B,T,K,hd)
    moved once, and the f32 row logsumexp read."""
    flops = 5 * 2 * b * h * attention_pairs(s, t, causal, window) * hd
    nbytes = (dtype.itemsize * (4 * b * s * h * hd + 4 * b * t * k * hd)
              + 4 * b * h * s)
    return flops, nbytes


def _weights(act: str) -> int:
    return 3 if act == "swiglu" else 2     # gelu reads no gate


def moe_gmm(b, e, c, d, f, act: str = "swiglu", dtype=torch.bfloat16,
            live_rows: int | None = None, live_experts: int | None = None):
    """The grouped FFN's forward: its products over the live rows (every
    row by default), the live experts' weights read, buf read and the
    output written."""
    rows = b * e * c if live_rows is None else live_rows
    experts = e if live_experts is None else live_experts
    n = _weights(act)
    flops = n * 2 * rows * d * f
    nbytes = dtype.itemsize * (n * experts * d * f + 2 * b * e * c * d)
    return flops, nbytes


def moe_gmm_bwd(b, e, c, d, f, act: str = "swiglu", dtype=torch.bfloat16,
                live_rows: int | None = None,
                live_experts: int | None = None):
    """The grouped FFN's backward: two products per weight (its gradient
    and its share of dX or dH; the recomputed up products are not the
    function's work); each weight read and its gradient written (gelu's
    w_gate gradient is written as zeros); buf and dY read, dX written."""
    rows = b * e * c if live_rows is None else live_rows
    experts = e if live_experts is None else live_experts
    n = _weights(act)
    flops = 2 * n * 2 * rows * d * f
    nbytes = dtype.itemsize * (2 * n * experts * d * f + 3 * b * e * c * d)
    if act != "swiglu":
        nbytes += dtype.itemsize * e * d * f
    return flops, nbytes


def ssd(b, nc, l, h, p, n, dtype=torch.bfloat16):
    """The SSD intra-chunk function, x in ``dtype``: the causal half of C Bᵀ
    (once per chunk, shared by the heads) and of M X, and the state product;
    x, dt, cum, B, C read once, y and the states (f32) written once."""
    pairs = l * (l + 1) // 2
    flops = 2 * b * nc * (pairs * n + h * pairs * p + h * l * n * p)
    nbytes = (dtype.itemsize * b * nc * l * h * p    # x
              + 4 * 2 * b * nc * l * h               # dt, cum
              + 4 * 2 * b * nc * l * n               # B, C
              + 4 * b * nc * l * h * p               # y
              + 4 * b * nc * h * n * p)              # states
    return flops, nbytes


def ssd_bwd(b, nc, l, h, p, n, dtype=torch.bfloat16):
    """The SSD backward, x in ``dtype``: per head the causal halves of
    dM = dy Xᵀ and of Mᵀ dy, B dS and X dSᵀ; per chunk C Bᵀ (recomputed),
    dC = dCB B and dB = dCBᵀ C; each input (x, dt, cum, B, C, dy, d states)
    read once and each gradient written once (dxc in x's dtype)."""
    pairs = l * (l + 1) // 2
    flops = 2 * b * nc * (h * (2 * pairs * p + 2 * l * n * p)
                          + 3 * pairs * n)
    rows = b * nc * l
    nbytes = (2 * dtype.itemsize * rows * h * p   # x, dxc
              + 4 * rows * h * p                  # dy
              + 4 * b * nc * h * n * p            # d states
              + 4 * 4 * rows * h                  # dt, cum, d dt, d cum
              + 4 * 4 * rows * n)                 # B, C, dB, dC
    return flops, nbytes
