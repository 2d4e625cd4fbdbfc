"""Plain PyTorch versions of the Mamba2 SSD primitive.

``ssd_reference`` is the stepwise recurrence, the definition the chunked
form must match.  ``ssd_intra_chunk_reference`` is the CPU path of
``ops.ssd_intra_chunk`` and the oracle the CUDA kernel is held against on the
card.  Both do their math in f32 (f64 inputs stay f64).  ``split3_bf16`` is
the split of an f32 operand into three bf16 parts that the CUDA kernel runs
its tensor-core products on; the tests hold the scheme against f64 sums."""
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
