"""Feed-forward blocks: SwiGLU/GELU MLP and capacity-based top-k MoE.

The MoE block is the JAX package's single-device dense dispatch: tokens are
scattered into per-expert capacity buffers (B,E,C,D), the grouped expert FFN
runs on them (``kernels.moe_gmm``: the hand-written CUDA kernel for CUDA
tensors, its plain version on the CPU), and the results are gathered back.
The expert-parallel paths of the reference wait for the multi-device slice
(ROADMAP.md, queue 1)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import grouped_ffn
from .common import normal_init
from .config import ArchConfig


def init_mlp_params(generator, d: int, ff: int, act: str, dtype, device,
                    lead: tuple = ()) -> dict:
    p = {
        "w_in": normal_init(generator, (*lead, d, ff), d ** -0.5, dtype,
                            device),
        "w_out": normal_init(generator, (*lead, ff, d), ff ** -0.5, dtype,
                             device),
    }
    if act == "swiglu":
        p["w_gate"] = normal_init(generator, (*lead, d, ff), d ** -0.5, dtype,
                                  device)
    return p


def mlp_forward(params, x, act: str) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, params["w_in"])
    if act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    return torch.einsum("bsf,fd->bsd", h, params["w_out"])


def init_moe_params(generator, cfg: ArchConfig, dtype, device,
                    lead: tuple = ()) -> dict:
    """The router is f32 whatever ``dtype`` is, as in the reference."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": normal_init(generator, (*lead, d, e), d ** -0.5,
                              torch.float32, device),
        "w_in": normal_init(generator, (*lead, e, d, ff), d ** -0.5, dtype,
                            device),
        "w_gate": normal_init(generator, (*lead, e, d, ff), d ** -0.5, dtype,
                              device),
        "w_out": normal_init(generator, (*lead, e, ff, d), ff ** -0.5, dtype,
                             device),
    }


def moe_capacity(cfg: ArchConfig, tokens_per_row: int) -> int:
    c = math.ceil(cfg.capacity_factor * tokens_per_row * cfg.top_k
                  / cfg.n_experts)
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) spelled the same on every device:
    ``F.one_hot`` checks the range on the CPU, scatters on the card and
    compares on meta, so a step's counted work would differ between them."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_forward(params, x, cfg: ArchConfig):
    """Top-k capacity-dispatch MoE.  x (B,S,D) -> (y, aux_loss).

    Per batch row, each expert takes at most ``moe_capacity(cfg, S)`` of the
    routed (token, choice) pairs, in (S, k) order; the rest are dropped
    (weight 0).  ``aux_loss`` is the Switch load-balancing loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, s)

    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                        # (B,S,E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (B,S,k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = _one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    # slot assignment: position of each routed token within its expert
    flat_e = top_i.reshape(b, s * k)                             # (B,T)
    onehot = _one_hot(flat_e, e)                                 # (B,T,E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    slot = pos_in_e.gather(-1, flat_e[..., None])[..., 0]        # (B,T)
    keep = slot < cap
    slot = torch.where(keep, slot, 0)
    w = top_p.reshape(b, s * k) * keep                           # (B,T)

    # scatter into (B,E,C,D): each kept (b, e, slot) gets exactly one token,
    # dropped ones add exact zeros at slot 0, so the sum is order-free
    x_tok = torch.repeat_interleave(x, k, dim=1)                 # (B,T,D)
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf.index_put_((b_idx, flat_e, slot), x_tok * keep[..., None].to(x.dtype),
                   accumulate=True)

    h = grouped_ffn(buf, params["w_in"], params["w_gate"], params["w_out"],
                    cfg.mlp_act)

    # gather back and combine with routing weights
    y_tok = h[b_idx, flat_e, slot] * w[..., None].to(x.dtype)    # (B,T,D)
    return y_tok.reshape(b, s, k, d).sum(dim=2), aux
