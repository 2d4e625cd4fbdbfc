"""Shared building blocks: device choice, norms, RoPE, init, the loss, and
the ambient mesh and sharding mode."""
from __future__ import annotations

import contextlib

import torch


def require_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller names another.

    Raises when CUDA is asked for and absent, instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return device


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale`` (the scales init to zero)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotates the two split halves of hd (not interleaved pairs) with f32
    angles and casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (...,S,hd/2)
    angles = angles[..., None, :]                            # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_DRAW_CHUNK = 1 << 26     # values drawn in f32 at once, at least one slice


def normal_init(generator: torch.Generator | None, shape, std: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std^2), drawn in f32 and cast into a preallocated leaf of
    ``dtype``, slice by slice of the leading axis: each draw covers whole
    slices, one or as many as fit 2^26 values.  The f32 buffer is that
    chunk, not the leaf: a stacked (L, E, D, F) expert leaf never needs an
    f32 copy of all L layers.

    ``device="meta"`` (with no generator) gives the leaf's shape and dtype
    without memory."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta or out.numel() == 0:
        return out
    rows = max(1, _DRAW_CHUNK // out[0].numel())
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32,
                               device=out.device).mul_(std))
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions; logits (B,S,V), labels (B,S) int.  f32
    logits, logsumexp minus the gold logit, plus ``z_loss * lse^2``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()


# "tp" (the default): the expert-parallel MoE combines by an all-reduce over
# "model".  "fsdp": it dispatches by all-to-all when "model" divides the
# sequence (``models/mlp.py``).  The reference's fsdp mode also shards every
# parameter over the whole mesh and the batch over every axis; the port
# computes those specs (``launch/shardings.py``) and does not carry them out.
SHARDING_MODE = ["tp"]
# the mesh of ``use_mesh``: a plain global, not a context variable, because
# the autograd engine runs a CUDA backward (and remat's recompute inside
# it) on threads of its own
_MESH = [None]


def set_sharding_mode(mode: str) -> None:
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding mode {mode!r}: want tp or fsdp")
    SHARDING_MODE[0] = mode


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model on ``mesh`` (a DeviceMesh, or None for one process),
    the counterpart of the reference's ``with mesh:``.  A training step's
    backward belongs inside too: remat recomputes the forward there."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev


def ambient_mesh():
    """The mesh ``use_mesh`` installed, or None."""
    return _MESH[0]
