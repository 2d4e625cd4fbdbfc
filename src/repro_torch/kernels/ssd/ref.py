"""Plain PyTorch versions of the Mamba2 SSD primitive.

``ssd_reference`` is the stepwise recurrence, the definition the chunked
form must match.  ``ssd_intra_chunk_reference`` is the CPU path of
``ops.ssd_intra_chunk`` and the oracle the CUDA kernel is held against on the
card; ``ssd_intra_chunk_backward_reference`` is the same for its backward.
All do their math in f32 (f64 inputs stay f64).  ``split3_bf16`` is
the split of an f32 operand into three bf16 parts that the CUDA kernels run
their tensor-core products on, and ``split_matmul`` a product summed from
such parts as the kernels sum it; the tests hold the scheme against f64
sums (nothing on the main path calls either)."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def ssd_reference(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  bmat: torch.Tensor, cmat: torch.Tensor,
                  h_init: torch.Tensor | None = None):
    """Direct SSM recurrence.

    xh (B,S,H,P), dt (B,S,H) post-softplus, a_log (H,) with A = -exp(a_log),
    bmat/cmat (B,S,N).  Returns (y (B,S,H,P) in xh's dtype, h_final
    (B,H,N,P) f32)."""
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    a = -torch.exp(a_log.float())
    x32, dt32 = xh.float(), dt.float()
    b32, c32 = bmat.float(), cmat.float()
    hcur = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=xh.device)
            if h_init is None else h_init.float())
    ys = []
    for t in range(s):
        da = torch.exp(dt32[:, t] * a)                          # (B,H)
        inc = torch.einsum("bh,bn,bhp->bhnp", dt32[:, t], b32[:, t],
                           x32[:, t])
        hcur = hcur * da[..., None, None] + inc
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, t], hcur))
    return torch.stack(ys, dim=1).to(xh.dtype), hcur


def ssd_intra_chunk_reference(xc: torch.Tensor, dtc: torch.Tensor,
                              cum: torch.Tensor, bc: torch.Tensor,
                              cc: torch.Tensor):
    """xc (B,NC,L,H,P), dtc (B,NC,L,H), cum (B,NC,L,H) = cumsum(dt*A) within
    each chunk, bc/cc (B,NC,L,N).  Returns (y_intra (B,NC,L,H,P), states
    (B,NC,H,N,P)) in f32 (in f64 for f64 inputs, to measure rounding):

        M[i,j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
        y_intra = M X
        states  = (exp(cum_{L-1} - cum) * dt * B)^T X
    """
    l = xc.shape[2]
    ct = torch.promote_types(xc.dtype, torch.float32)
    dtc, cum = dtc.to(ct), cum.to(ct)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,NC,L,L,H)
    idx = torch.arange(l, device=xc.device)
    causal = idx[:, None] >= idx[None, :]
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  NEG_INF))
    bc, cc = bc.to(ct), cc.to(ct)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]
    x = xc.to(ct)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, x)
    w_state = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,NC,L,H)
    states = torch.einsum("bclh,bcln,bclhp->bchnp", w_state, bc, x)
    return y_intra, states


def ssd_intra_chunk_backward_reference(xc, dtc, cum, bc, cc, dy=None,
                                       dstates=None):
    """The gradients of ``ssd_intra_chunk_reference``'s inputs, given the
    cotangents ``dy`` (B,NC,L,H,P) of y_intra and ``dstates`` (B,NC,H,N,P)
    of the states (either may be None: no gradient flows from it).  The
    formulas written out, not autograd; per (b, c, h), with E[i,j] =
    exp(cum_i - cum_j) for i >= j (else 0), M = CB * E * dt_j and w_l =
    exp(cum_{L-1} - cum_l) dt_l:

        dM        = dy X^T                      (its causal half weighs in)
        dX        = M^T dy + w * (B dS)
        dw_l      = sum_p X[l,p] (B dS)[l,p]    (= sum_n B[l,n] (X dS^T)[l,n])
        dCB       = sum_h dM * E * dt_j;   dC = dCB B;   dB = dCB^T C
                    + sum_h w * (X dS^T)
        d dt_j    = sum_i dM * CB * E + dw_j exp(cum_{L-1} - cum_j)
        d cum     = rows of Q - columns of Q - dw * w, and + sum_l dw_l w_l
                    on row L-1, with Q = dM * M

    Returns (dxc in xc's dtype, d dtc, d cum, d bc, d cc), the last four in
    f32 (f64 for f64 inputs, to measure rounding)."""
    l = xc.shape[2]
    ct = torch.promote_types(xc.dtype, torch.float32)
    dtc, cum, bc, cc = (t.to(ct) for t in (dtc, cum, bc, cc))
    x = xc.to(ct)
    dx = torch.zeros_like(x)
    ddt = torch.zeros_like(dtc)
    dcum = torch.zeros_like(cum)
    dbc = torch.zeros_like(bc)
    dcc = torch.zeros_like(cc)
    if dy is not None:
        dy = dy.to(ct)
        idx = torch.arange(l, device=xc.device)
        causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
        # masked before the exponential: exp(-2^30) is 0, never inf * 0
        e = torch.exp(torch.where(causal,
                                  cum[:, :, :, None, :] - cum[:, :, None],
                                  NEG_INF))                     # (B,NC,i,j,H)
        cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
        m = cb[..., None] * e * dtc[:, :, None]
        dm = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
        dx = dx + torch.einsum("bcijh,bcihp->bcjhp", m, dy)
        g = dm * e                                               # dM * E
        dcb = torch.einsum("bcijh,bcjh->bcij", g, dtc)
        d = g * cb[..., None]                                    # dM * CB * E
        ddt = ddt + d.sum(2)
        q = d * dtc[:, :, None]                                  # dM * M
        dcum = dcum + q.sum(3) - q.sum(2)
        dcc = dcc + torch.einsum("bcij,bcjn->bcin", dcb, bc)
        dbc = dbc + torch.einsum("bcij,bcin->bcjn", dcb, cc)
    if dstates is not None:
        ds = dstates.to(ct)
        decay = torch.exp(cum[:, :, -1:, :] - cum)              # (B,NC,L,H)
        w = decay * dtc
        u = torch.einsum("bcln,bchnp->bclhp", bc, ds)            # B dS
        dx = dx + w[..., None] * u
        dw = torch.einsum("bclhp,bclhp->bclh", x, u)
        ddt = ddt + dw * decay
        dbc = dbc + torch.einsum("bclh,bclhp,bchnp->bcln", w, x, ds)
        dww = dw * w
        dcum = dcum - dww
        dcum[:, :, -1] += dww.sum(2)
    return dx.to(xc.dtype), ddt, dcum, dbc, dcc


def split3_bf16(t: torch.Tensor):
    """An f32 tensor as three bf16 tensors (hi, mid, lo), each the residue
    of the one before rounded to bf16, so that hi + mid + lo == t exactly:
    8 + 8 + 8 bits of the 24-bit significand.  The CUDA kernel splits M and
    w·B so before its bf16 tensor-core products."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_matmul(a: torch.Tensor, b: torch.Tensor, a_parts: int = 3,
                 b_parts: int = 3, order: int = 2) -> torch.Tensor:
    """``a @ b`` (f32, batched) as the CUDA kernels compute it on bf16
    tensor cores: each operand cut into its first ``a_parts`` / ``b_parts``
    bf16 parts (``split3_bf16``; one part for an operand that holds bf16
    values, which the first part carries exactly), the part-products
    ``a_q @ b_r`` with ``q + r <= order`` (a part-product weighs about
    2^-8(q + r) of the whole: order 2 keeps those down to 2^-16), each
    summed in f32 and added into an f32 sum, the lightest first."""
    ap = [t.float() for t in split3_bf16(a)[:a_parts]]
    bp = [t.float() for t in split3_bf16(b)[:b_parts]]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1]), dtype=torch.float32)
    for s in range(order, -1, -1):
        for q, aq in enumerate(ap):
            if 0 <= s - q < len(bp):
                out = out + aq @ bp[s - q]
    return out
