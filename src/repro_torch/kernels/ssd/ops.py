"""Public SSD intra-chunk entry: the CUDA kernel on the card, the plain
version on the CPU.

The tensors' device decides.  CUDA tensors launch the hand-written kernel or
raise; nothing falls back to the plain version.  ``ssd_intra_chunk.launches``
counts calls that launched the kernel (one call is one launch of the C·Bᵀ
kernel and one of the y and state kernel), and nothing else.

The JAX wrapper's ``interpret`` flag has no counterpart: the device of the
tensors takes its place.

The kernel has no backward yet: a CUDA input that needs a gradient raises,
where autograd would otherwise leave every parameter upstream without one."""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import ssd_intra_chunk_cuda
from .ref import ssd_intra_chunk_reference, ssd_reference

X_DTYPES = (torch.float32, torch.bfloat16)
MAX_L, MAX_N, MAX_P = 256, 128, 64


def _check_cuda_inputs(xc, dtc, cum, bc, cc) -> None:
    if xc.dtype not in X_DTYPES or any(
            t.dtype != torch.float32 for t in (dtc, cum, bc, cc)):
        raise TypeError(f"ssd_intra_chunk takes xc in float32 or bfloat16 "
                        f"and dtc, cum, bc, cc in float32; got "
                        f"{[str(t.dtype) for t in (xc, dtc, cum, bc, cc)]}")
    if xc.dim() != 5 or dtc.dim() != 4 or bc.dim() != 4:
        raise ValueError(f"want xc (B,NC,L,H,P), dtc/cum (B,NC,L,H), bc/cc "
                         f"(B,NC,L,N); got {tuple(xc.shape)}, "
                         f"{tuple(dtc.shape)}, {tuple(bc.shape)}")
    b, nc, l, h, p = xc.shape
    n = bc.shape[-1]
    if dtc.shape != (b, nc, l, h) or cum.shape != dtc.shape or \
            bc.shape != (b, nc, l, n) or cc.shape != bc.shape:
        raise ValueError(f"shapes disagree: xc {tuple(xc.shape)}, dtc "
                         f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}, bc "
                         f"{tuple(bc.shape)}, cc {tuple(cc.shape)}")
    if min(b, nc, l, h, p, n) == 0:
        raise ValueError("empty input")
    if l > MAX_L or n > MAX_N or p > MAX_P:
        raise ValueError(f"the kernel takes L <= {MAX_L}, N <= {MAX_N} and "
                         f"P <= {MAX_P}; got L {l}, N {n}, P {p}")
    if b * nc > 65535 or h > 65535:
        raise ValueError("more than 65535 batch rows x chunks or heads")
    if any(t.stride(-1) != 1 for t in (xc, bc, cc)):
        raise ValueError("the last dim of xc, bc and cc must be contiguous")


NO_GRAD = ("ssd_intra_chunk on the card has no backward yet; it comes with "
           "SSM and hybrid training, an SSD backward (ROADMAP.md, queue 1). "
           "Call it under torch.no_grad() or on inputs that need no "
           "gradient")


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                    bc: torch.Tensor, cc: torch.Tensor):
    """xc (B,NC,L,H,P), dtc/cum (B,NC,L,H), bc/cc (B,NC,L,N) ->
    (y_intra (B,NC,L,H,P) f32, states (B,NC,H,N,P) f32); see
    ``ssd_intra_chunk_reference`` for the function."""
    ts = (xc, dtc, cum, bc, cc)
    if any(t.device != xc.device for t in ts) or \
            xc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the inputs must lie on the CPU or on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    if xc.device.type == "cpu":
        return ssd_intra_chunk_reference(*ts)
    refuse_grad(NO_GRAD, *ts)
    _check_cuda_inputs(*ts)
    out = ssd_intra_chunk_cuda(*ts)
    ssd_intra_chunk.launches += 1
    return out


ssd_intra_chunk.launches = 0


__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_reference", "ssd_reference"]
