"""Plain PyTorch versions of the grouped expert FFN and of its backward.

The CPU path of ``ops.grouped_ffn`` (and of its autograd Function's
backward) and the oracles the CUDA kernels are held against on the card."""
from __future__ import annotations

import math

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


_GELU_C = (2.0 / math.pi) ** 0.5
_GELU_A = 0.044715


def grouped_ffn_backward_reference(buf: torch.Tensor, w_in: torch.Tensor,
                                   w_gate: torch.Tensor, w_out: torch.Tensor,
                                   dy: torch.Tensor, act: str = "swiglu"):
    """The gradients of ``grouped_ffn_reference`` at (buf, w_in, w_gate,
    w_out) for the output's cotangent ``dy`` (B,E,C,D): (dbuf, dw_in,
    dw_gate, dw_out), each in its input's dtype.

    Written out in f32, not through autograd.  With A = X W_in, G = X W_gate
    and s = sigmoid(G): swiglu H = silu(G) A, dH = dY W_out^T, dA = dH
    silu(G), dG = dH A s (1 + G (1 - s)); gelu H = gelu_tanh(A), dA = dH
    gelu_tanh'(A), dG = 0.  Then dX = dA W_in^T + dG W_gate^T, dW_in = X^T
    dA, dW_gate = X^T dG, dW_out = H^T dY, each weight gradient summed over
    the B*C rows of its expert.  For gelu ``w_gate`` is not read and its
    gradient is zeros, as ``jax.grad`` gives."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}; got {act!r}")
    x, wi, wo, g_y = buf.float(), w_in.float(), w_out.float(), dy.float()
    a = torch.einsum("becd,edf->becf", x, wi)
    dh = torch.einsum("becd,efd->becf", g_y, wo)
    if act == "swiglu":
        wg = w_gate.float()
        g = torch.einsum("becd,edf->becf", x, wg)
        s = torch.sigmoid(g)
        silu = F.silu(g)
        h = silu * a
        da = dh * silu
        dg = dh * a * s * (1.0 + g * (1.0 - s))
        dx = (torch.einsum("becf,edf->becd", da, wi)
              + torch.einsum("becf,edf->becd", dg, wg))
        dw_gate = torch.einsum("becd,becf->edf", x, dg).to(w_gate.dtype)
    else:
        h = F.gelu(a, approximate="tanh")
        t = torch.tanh(_GELU_C * (a + _GELU_A * a ** 3))
        da = dh * (0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _GELU_C
                   * (1.0 + 3.0 * _GELU_A * a * a))
        dx = torch.einsum("becf,edf->becd", da, wi)
        dw_gate = torch.zeros_like(w_gate)
    dw_in = torch.einsum("becd,becf->edf", x, da)
    dw_out = torch.einsum("becf,becd->efd", h, g_y)
    return (dx.to(buf.dtype), dw_in.to(w_in.dtype), dw_gate,
            dw_out.to(w_out.dtype))
