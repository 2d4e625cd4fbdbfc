"""Plain PyTorch version of flash attention (GQA, causal, sliding window).

The CPU path of ``ops.flash_attention`` and the oracle the CUDA kernel is held
against on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,K,hd) with H a multiple of K.  f32 softmax.

    Masked scores take the finite ``NEG_INF``, so a fully masked row averages
    v uniformly, as in the JAX oracle."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows + (t - s)
    if window > 0:
        mask &= cols > rows + (t - s) - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)
