"""The yardstick's work counts and peaks, frozen here so that a change to the
program cannot move them.

- ``attention_pairs``, ``flash_fwd``, ``flash_bwd``, ``ssd``, ``ssd_bwd``:
  copied from ``src/repro_torch/roofline/kernel_model.py`` (the same
  arithmetic; dtype sizes passed as byte counts).
- ``param_counts``: copied from ``src/repro_torch/models/config.py::
  ArchConfig.param_counts``; ``model_flops``: copied from
  ``src/repro_torch/roofline/model.py::model_flops``.
- ``PEAK_FLOPS``, ``HBM_BW``: NVIDIA's data-sheet peaks of one H100 SXM
  (dense bf16 tensor-core FLOP/s, HBM3 bytes/s) at its 700 W limit, as
  ``src/repro_torch/roofline/model.py`` states them.

A configuration is the ``arch`` object of its file under
``bench/configs``, read through ``Arch``.
"""
from __future__ import annotations

import functools

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


class Arch:
    """The sizes of a configuration file's ``arch`` object, with the
    derived sizes the counts read."""

    def __init__(self, fields: dict) -> None:
        self.__dict__.update({"n_experts": 0, "top_k": 0, "moe_dense_ff": 0,
                              "shared_expert_ff": 0, "attn_every": 0,
                              "enc_layers": 0, "tie_embeddings": False,
                              "mlp_act": "swiglu", "ssm_state": 0,
                              "ssm_expand": 2, "ssm_head_dim": 64,
                              "ssm_conv": 4, "ssm_chunk": 256,
                              "norm_eps": 1e-6, "rope_theta": 10000.0})
        self.__dict__.update(fields)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_layers(self) -> int:
        """Attention layers a forward runs (the hybrid's shared block once
        per block of ``attn_every`` mamba layers)."""
        if self.family in ("ssm",):
            return 0
        if self.family == "hybrid":
            return self.n_layers // self.attn_every
        return self.n_layers

    @property
    def mamba_layers(self) -> int:
        return self.n_layers if self.family in ("ssm", "hybrid") else 0


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of work: the larger of its operations at the peak
    FLOP/s and its bytes at the peak HBM rate."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


@functools.lru_cache(maxsize=256)
def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: row i (of s) sees keys up to
    i + t - s when causal, and only the last ``window`` of those when
    ``window > 0``."""
    total = 0
    for i in range(s):
        diag = i + t - s
        hi = min(diag, t - 1) if causal else t - 1
        lo = max(diag - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_fwd(b, s, t, h, k, hd, causal=True, window=0, itemsize=2,
              with_lse=False):
    """softmax(q kᵀ) v: q·kᵀ and p·v over the kept pairs; q, k, v read, o
    written (and the f32 row logsumexp, when the forward keeps it)."""
    flops = 4 * b * h * attention_pairs(s, t, causal, window) * hd
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * t * k * hd)
    if with_lse:
        nbytes += 4 * b * h * s
    return flops, nbytes


def flash_bwd(b, s, t, h, k, hd, causal=True, window=0, itemsize=2):
    """The backward's five products over the kept pairs; q, o, do, dq and
    k, v, dk, dv moved once, and the f32 row logsumexp read."""
    flops = 5 * 2 * b * h * attention_pairs(s, t, causal, window) * hd
    nbytes = (itemsize * (4 * b * s * h * hd + 4 * b * t * k * hd)
              + 4 * b * h * s)
    return flops, nbytes


def ssd(b, nc, l, h, p, n, itemsize=2):
    """The SSD intra-chunk function: the causal half of C Bᵀ (once per
    chunk) and of M X, and the state product; x, dt, cum, B, C read once,
    y and the states (f32) written once."""
    pairs = l * (l + 1) // 2
    flops = 2 * b * nc * (pairs * n + h * pairs * p + h * l * n * p)
    nbytes = (itemsize * b * nc * l * h * p
              + 4 * 2 * b * nc * l * h
              + 4 * 2 * b * nc * l * n
              + 4 * b * nc * l * h * p
              + 4 * b * nc * h * n * p)
    return flops, nbytes


def ssd_bwd(b, nc, l, h, p, n, itemsize=2):
    """The SSD backward: per head the causal halves of dM = dy Xᵀ and of
    Mᵀ dy, B dS and X dSᵀ; per chunk C Bᵀ, dC and dB; each input read once
    and each gradient written once."""
    pairs = l * (l + 1) // 2
    flops = 2 * b * nc * (h * (2 * pairs * p + 2 * l * n * p)
                          + 3 * pairs * n)
    rows = b * nc * l
    nbytes = (2 * itemsize * rows * h * p
              + 4 * rows * h * p
              + 4 * b * nc * h * n * p
              + 4 * 4 * rows * h
              + 4 * 4 * rows * n)
    return flops, nbytes


def param_counts(cfg: Arch) -> dict:
    """Total and active (per token) parameters."""
    d, hd = cfg.d_model, cfg.head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    att = d * h * hd + 2 * d * k * hd + h * hd * d if h else 0
    mlp_per_ff = 3 * d if cfg.mlp_act == "swiglu" else 2 * d
    if cfg.family == "ssm":
        di, st = cfg.d_inner, cfg.ssm_state
        layer_total = layer_active = d * (2 * di + 2 * st + cfg.ssm_heads) \
            + di * d
    elif cfg.family == "hybrid":
        di, st = cfg.d_inner, cfg.ssm_state
        ssm_p = d * (2 * di + 2 * st + cfg.ssm_heads) + di * d
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        shared = att + mlp_per_ff * cfg.d_ff
        layer_total = ssm_p + shared / cfg.n_layers
        layer_active = ssm_p + shared * n_attn / cfg.n_layers
    else:
        layer_total = layer_active = att
        if cfg.n_experts:
            layer_total += cfg.n_experts * mlp_per_ff * cfg.d_ff
            layer_active += cfg.top_k * mlp_per_ff * cfg.d_ff
            for ff in (cfg.moe_dense_ff, cfg.shared_expert_ff):
                layer_total += mlp_per_ff * ff
                layer_active += mlp_per_ff * ff
        else:
            layer_total += mlp_per_ff * cfg.d_ff
            layer_active += mlp_per_ff * cfg.d_ff
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return {"total": embed + cfg.n_layers * layer_total,
            "active": embed + cfg.n_layers * layer_active}


def model_flops(cfg: Arch, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS of one step: 6 N_active tokens for a training
    step, 2 N_active tokens for inference, plus the attention products
    (the causal half of the quadratic term; decode attends to ``seq``
    positions once per new token) and the hybrid's SSD term."""
    n_active = param_counts(cfg)["active"]
    attn_heads = cfg.n_heads * cfg.head_dim
    l_attn = cfg.n_layers if cfg.family not in ("ssm", "hybrid") else (
        cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)
    ssd_term = (2 * cfg.d_inner * cfg.ssm_state * 3
                if cfg.family in ("ssm", "hybrid") else 0)
    if kind == "train":
        tokens = batch * seq
        return (6.0 * n_active * tokens
                + 3.0 * 2.0 * 2.0 * l_attn * attn_heads * (seq / 2) * tokens
                + 6.0 * cfg.n_layers * tokens * ssd_term)
    if kind == "prefill":
        tokens = batch * seq
        return (2.0 * n_active * tokens
                + 2.0 * 2.0 * l_attn * attn_heads * (seq / 2) * tokens
                + 2.0 * cfg.n_layers * tokens * ssd_term)
    if kind == "decode":
        tokens = batch
        return (2.0 * n_active * tokens
                + 2.0 * 2.0 * l_attn * attn_heads * seq * tokens
                + 2.0 * cfg.n_layers * tokens * ssd_term)
    raise ValueError(kind)
