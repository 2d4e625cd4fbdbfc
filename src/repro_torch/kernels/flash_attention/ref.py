"""Plain PyTorch version of flash attention (GQA, causal, sliding window),
forward and backward.

The CPU path of ``ops.flash_attention`` and of ``ops.FlashAttention``'s
backward, and the oracle the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _scores(q, k, causal, window, scale):
    """Scaled, masked scores (B, K, G, S, T) in f32 (f64 for f64 inputs),
    and the (S, T) mask, True where a key is kept: causal with the diagonal
    offset T - S, and the last ``window`` keys of each row when
    ``window > 0``."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    scores = scores.to(torch.promote_types(q.dtype, torch.float32)) * scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows + (t - s)
    if window > 0:
        mask &= cols > rows + (t - s) - window
    return scores.masked_fill(~mask, NEG_INF), mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        return_lse: bool = False):
    """q (B,S,H,hd), k/v (B,T,K,hd) with H a multiple of K.  f32 softmax.

    Masked scores take the finite ``NEG_INF``, so a fully masked row averages
    v uniformly, as in the JAX oracle.  ``return_lse`` also returns each
    row's logsumexp of the scaled, masked scores: f32 (B,H,S), natural log."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    scores, _ = _scores(q, k, causal, window, scale)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, h, hd)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def attention_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                                 window: int = 0, scale: float | None = None):
    """(dq, dk, dv) of ``attention_reference`` from its output ``o``, its
    row logsumexp ``lse`` (B,H,S) and the output's cotangent ``do``:

        D = rowsum(do * o),  P = exp(s * scale - lse),  dv = P^T do,
        dP = do v^T,  dS = P * (dP - D),  dq = dS k scale,  dk = dS^T q scale

    dk and dv sum over each kv head's H / K query heads.  The sums run in
    f32 (f64 for f64 inputs); the results come back in the inputs' dtype."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5 if scale is None else scale
    dt = q.dtype
    ct = torch.promote_types(dt, torch.float32)
    q, k, v, o, do = (x.to(ct) for x in (q, k, v, o, do))
    scores, mask = _scores(q, k, causal, window, scale)
    p = torch.exp(scores - lse.to(ct).reshape(b, kh, g, s)[..., None])
    p = p.masked_fill(~mask, 0.0)
    qg, og, dog = (x.reshape(b, s, kh, g, hd) for x in (q, o, do))
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # (B,K,G,S,1)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k).reshape(b, s, h, hd) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)
