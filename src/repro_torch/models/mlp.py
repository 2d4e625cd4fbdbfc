"""Dense feed-forward block: SwiGLU or GELU MLP.

The MoE block (and its grouped-FFN kernel) is ported in a later slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import normal_init


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
