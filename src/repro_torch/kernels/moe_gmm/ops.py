"""Public grouped expert FFN: the CUDA kernel on the card, the plain version
on the CPU.

The tensor's device decides.  A CUDA tensor launches the hand-written kernel
or raises; nothing falls back to the plain version.  ``grouped_ffn.
launches`` counts calls that launched the kernel (one call is one launch of
the up product and one of the down product), and nothing else.

The JAX wrapper's ``bf`` (the TPU's F block) has no counterpart: the CUDA
kernel picks its own tiles and masks the ragged edge.

The kernel has no backward yet: a CUDA input that needs a gradient raises,
where autograd would otherwise leave every parameter upstream without one."""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import grouped_ffn_cuda
from .ref import ACTS, grouped_ffn_reference

DTYPES = (torch.float32, torch.bfloat16)


def _operands(buf, w_in, w_gate, w_out, act: str) -> tuple:
    """The tensors the function reads: gelu does not read ``w_gate``."""
    return (buf, w_in, w_gate, w_out) if act == "swiglu" else \
        (buf, w_in, w_out)


def _check_cuda_inputs(buf, w_in, w_gate, w_out, act: str) -> None:
    mats = _operands(buf, w_in, w_gate, w_out, act)
    if buf.dtype not in DTYPES or any(x.dtype != buf.dtype for x in mats):
        raise TypeError(f"grouped_ffn takes float32 or bfloat16 tensors of "
                        f"one dtype; got {[x.dtype for x in mats]}")
    if buf.dim() != 4 or w_in.dim() != 3 or w_out.dim() != 3:
        raise ValueError(f"want buf (B,E,C,D), w_in (E,D,F), w_out (E,F,D); "
                         f"got {tuple(buf.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(w_out.shape)}")
    b, e, c, d = buf.shape
    f = w_in.shape[-1]
    if w_in.shape != (e, d, f) or w_out.shape != (e, f, d) or (
            act == "swiglu" and w_gate.shape != w_in.shape):
        raise ValueError(f"shapes disagree: buf {tuple(buf.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    if min(b, e, c, d, f) == 0:
        raise ValueError("empty buffer or weights")
    if e > 65535 or b * c >= 2 ** 31:
        raise ValueError("more than 65535 experts or 2^31 rows per expert")
    if any(x.stride(-1) != 1 for x in mats):
        raise ValueError("the last dim of buf and of the weights must be "
                         "contiguous")
    # the bf16 kernel loads rows 16 bytes (8 values) at a time
    if buf.dtype == torch.bfloat16 and (d % 8 or f % 8 or any(
            x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1])
            for x in mats)):
        raise ValueError("bfloat16 rows must start 16-byte aligned: D and F "
                         "multiples of 8, data pointers on 16 bytes, strides "
                         "multiples of 8")


NO_GRAD = ("grouped_ffn on the card has no backward yet; it comes with MoE "
           "training, a moe_gmm backward (ROADMAP.md, queue 1). Call it "
           "under torch.no_grad() or on inputs that need no gradient")


def grouped_ffn(buf: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
                w_out: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """buf (B,E,C,D); w_in/w_gate (E,D,F); w_out (E,F,D) -> (B,E,C,D).

    Per (b, e): silu(X W_gate) * (X W_in) then W_out (swiglu), or
    gelu_tanh(X W_in) W_out (gelu; ``w_gate`` is not read).  f32 sums; the
    output is in buf's dtype."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}; got {act!r}")
    mats = _operands(buf, w_in, w_gate, w_out, act)
    if any(x.device != buf.device for x in mats) or \
            buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"buf and the weights must lie on the CPU or on one "
                         f"CUDA device; got {[str(x.device) for x in mats]}")
    if buf.device.type == "cpu":
        return grouped_ffn_reference(buf, w_in, w_gate, w_out, act)
    refuse_grad(NO_GRAD, *mats)
    _check_cuda_inputs(buf, w_in, w_gate, w_out, act)
    out = grouped_ffn_cuda(buf, w_in, w_gate if act == "swiglu" else w_in,
                           w_out, act)
    grouped_ffn.launches += 1
    return out


grouped_ffn.launches = 0


__all__ = ["grouped_ffn", "grouped_ffn_reference"]
