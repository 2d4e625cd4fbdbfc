"""Plain PyTorch version of the grouped expert FFN.

The CPU path of ``ops.grouped_ffn`` and the oracle the CUDA kernel is held
against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = ("swiglu", "gelu")


def grouped_ffn_reference(buf: torch.Tensor, w_in: torch.Tensor,
                          w_gate: torch.Tensor, w_out: torch.Tensor,
                          act: str = "swiglu") -> torch.Tensor:
    """buf (B,E,C,D); w_in/w_gate (E,D,F); w_out (E,F,D) -> (B,E,C,D).

    Per (b, e): silu(X W_gate) * (X W_in), then W_out, for swiglu;
    gelu_tanh(X W_in) W_out for gelu (``w_gate`` is then not read).  The math
    is in f32, the output in ``buf``'s dtype."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}; got {act!r}")
    x = buf.float()
    h = torch.einsum("becd,edf->becf", x, w_in.float())
    if act == "swiglu":
        g = torch.einsum("becd,edf->becf", x, w_gate.float())
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    return torch.einsum("becf,efd->becd", h, w_out.float()).to(buf.dtype)
