"""Three-term roofline model for one NVIDIA H100 SXM (the port's target).

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = HBM bytes_per_device / HBM_bw
    collective term = NVLink bytes_per_device / link_bw

The counterpart of the JAX package's TPU v5e model, with the same
``RooflineReport`` fields and ``finalize`` logic.  The FLOPs and bytes come
from ``counting.Counter`` (one step run under it, on the meta device by the
dry run or on the card), not from compiled HLO.  MODEL_FLOPS (6*N*D
analytic) is reported alongside to expose remat and redundant work.

The constants are NVIDIA's data-sheet peaks for the SXM part (dense rates,
no sparsity, at the full 700 W power limit): estimates from the data sheet,
not measurements.  The collective term is 0 on one card.  On a production
mesh (the mesh dry run) the report's collective term prices every link
byte at NVLink's rate, as the reference prices its ICI; an NVLink Switch
System's domain reaches 256 H100s, one (16, 16) pod.  The "pod" axis of
(2, 16, 16) crosses pods over the network instead: ``collective_s_by_axis``
prices it at ``POD_BW``, one 400 Gb/s NDR InfiniBand port a card (a
data-sheet rate too), and the others at ``NVLINK_BW``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..models.config import ArchConfig

PEAK_FLOPS = 989e12         # dense bf16 tensor-core FLOP/s
PEAK_F32_FLOPS = 67e12      # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # HBM3 B/s
HBM_BYTES = 80e9            # device memory
NVLINK_BW = 450e9           # B/s per direction to the host's other cards
POD_BW = 50e9               # B/s per direction, one NDR port a card


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_by_kind: dict[str, float]
    model_flops_global: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0     # MODEL_FLOPS / (counted flops global)
    peak_fraction: float = 0.0    # MODEL_FLOPS-based MFU upper bound

    def finalize(self) -> "RooflineReport":
        self.compute_s = self.flops_per_device / PEAK_FLOPS
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / NVLINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        counted_global = self.flops_per_device * self.chips
        self.useful_ratio = (self.model_flops_global / counted_global
                             if counted_global else 0.0)
        step = max(self.compute_s, self.memory_s, self.collective_s)
        if step > 0:
            achievable = self.model_flops_global / (step * self.chips)
            self.peak_fraction = achievable / PEAK_FLOPS
        return self

    def row(self) -> dict:
        return dataclasses.asdict(self)


def collective_s_by_axis(by_axis: dict[str, float]) -> dict[str, float]:
    """Seconds of each mesh axis's link bytes (``Counter``'s
    ``collective_by_axis``): "pod" at ``POD_BW``, every other axis at
    ``NVLINK_BW`` (data-sheet rates)."""
    return {a: b / (POD_BW if a == "pod" else NVLINK_BW)
            for a, b in by_axis.items()}


def model_flops(cfg: ArchConfig, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS for one step (global, all chips), a copy of the
    reference's formula, its counting included: the encoder-decoder counts
    its decoder tokens only, not the encoder's frames.

    6*N_active*tokens for train (fwd+bwd), 2*N_active*tokens for inference,
    plus the attention score/value matmuls (causal halves the quadratic
    term; decode attends to the full cache once per new token)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    attn_heads = cfg.n_heads * cfg.head_dim
    l_attn = cfg.n_layers if cfg.family not in ("ssm", "hybrid") else (
        cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)

    if kind == "train":
        tokens = batch * seq
        flops = 6.0 * n_active * tokens
        flops += 3.0 * 2.0 * 2.0 * l_attn * attn_heads * (seq / 2) * tokens
        if cfg.family in ("ssm", "hybrid"):
            # SSD: ~ 3 matmul-equivalents over (state x head_dim) per token
            flops += 6.0 * cfg.n_layers * tokens * (
                2 * cfg.d_inner * cfg.ssm_state * 3)
        return flops
    if kind == "prefill":
        tokens = batch * seq
        flops = 2.0 * n_active * tokens
        flops += 2.0 * 2.0 * l_attn * attn_heads * (seq / 2) * tokens
        if cfg.family in ("ssm", "hybrid"):
            flops += 2.0 * cfg.n_layers * tokens * (
                2 * cfg.d_inner * cfg.ssm_state * 3)
        return flops
    if kind == "decode":
        tokens = batch  # one new token per sequence
        flops = 2.0 * n_active * tokens
        flops += 2.0 * 2.0 * l_attn * attn_heads * seq * tokens
        if cfg.family in ("ssm", "hybrid"):
            flops += 2.0 * cfg.n_layers * tokens * (
                2 * cfg.d_inner * cfg.ssm_state * 3)
        return flops
    raise ValueError(kind)
