"""Decoder-only LM: the dense family (deepseek, phi4, granite, gemma3), the
MoE family (arctic, llama4-scout) and the SSM family (mamba2).

One parameter tree with the JAX package's names and its stacked-over-layers
layout (``layers.attn.wq`` is (L, D, H, hd)); the layer loop is a Python
loop over views of the stacked leaves.  Entry points:

    forward(params, tokens, cfg)              -> logits, cache|None
    prefill(params, batch, cfg)               -> last-token logits, cache
    decode_step(params, tokens, cache, cfg)   -> logits (cache updated in place)

Cache layouts (each with "pos": (B,) int64):
    attention families: {"k": (L,B,T,K,hd), "v": ...}
    ssm:                {"conv": (L,B,ck-1,di+2N), "ssm": (L,B,H,N,P)}

The other families (hybrid, encdec, vlm) are ported in later slices
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import decode_attention, full_attention, init_attn_params
from .common import dtype_of, normal_init, rms_norm
from .config import ArchConfig
from .mlp import init_mlp_params, init_moe_params, mlp_forward, moe_forward
from .ssm import init_mamba_params, mamba_decode, mamba_forward

FAMILIES = ("dense", "moe", "ssm")
_LATER = {
    "hybrid": "queue 1, item 2 (hybrid)",
    "encdec": "queue 1, item 4 (encoder-decoder and VLM)",
    "vlm": "queue 1, item 4 (encoder-decoder and VLM)",
}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see "
            f"ROADMAP.md, {_LATER.get(cfg.family, 'queue 1')}")


# --------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """Draw the parameter tree leaf by leaf (f32 draws, cast to
    ``cfg.param_dtype``; the MoE router and mamba's ``A_log``, ``D`` and
    ``dt_bias`` stay f32).  On ``device="meta"`` it
    only describes shapes.  Raises ``NotImplementedError`` for the families
    not ported yet."""
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    d, n = cfg.d_model, cfg.n_layers
    params: dict = {
        "embed": normal_init(generator, (cfg.vocab, d), 0.02, dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator, (d, cfg.vocab), d ** -0.5,
                                        dtype, device)
    if cfg.family == "ssm":
        params["layers"] = init_mamba_params(generator, cfg, dtype, device,
                                             lead=(n,))
        params["layers"]["ln"] = torch.zeros((n, d), dtype=dtype,
                                             device=device)
        return params
    layers = params["layers"] = {
        "ln1": torch.zeros((n, d), dtype=dtype, device=device),
        "ln2": torch.zeros((n, d), dtype=dtype, device=device),
        "attn": init_attn_params(generator, cfg, dtype, device, lead=(n,)),
    }
    if not cfg.n_experts:
        layers["mlp"] = init_mlp_params(generator, d, cfg.d_ff, cfg.mlp_act,
                                        dtype, device, lead=(n,))
        return params
    layers["moe"] = init_moe_params(generator, cfg, dtype, device, lead=(n,))
    if cfg.moe_dense_ff:
        layers["dense_mlp"] = init_mlp_params(
            generator, d, cfg.moe_dense_ff, cfg.mlp_act, dtype, device,
            lead=(n,))
    if cfg.shared_expert_ff:
        layers["shared_mlp"] = init_mlp_params(
            generator, d, cfg.shared_expert_ff, cfg.mlp_act, dtype, device,
            lead=(n,))
    return params


# ----------------------------------------------------------------- helpers
def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _window(cfg: ArchConfig, i: int) -> int:
    return 0 if cfg.is_global_layer(i) else cfg.sliding_window


def _logits(params, h, cfg: ArchConfig):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return torch.einsum("bsd,dv->bsv", h, head)


def _embed(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _ffn(lp, m, cfg: ArchConfig):
    """The block's feed-forward half: the MLP, or the MoE plus arctic's
    dense residual FFN and llama4's shared expert.  The MoE aux loss is not
    needed for serving and is dropped."""
    if not cfg.n_experts:
        return mlp_forward(lp["mlp"], m, cfg.mlp_act)
    y, _ = moe_forward(lp["moe"], m, cfg)
    if cfg.moe_dense_ff:
        y = y + mlp_forward(lp["dense_mlp"], m, cfg.mlp_act)
    if cfg.shared_expert_ff:
        y = y + mlp_forward(lp["shared_mlp"], m, cfg.mlp_act)
    return y


def _block_forward(lp, h, positions, window: int, cfg: ArchConfig):
    """One transformer block on a full sequence; window 0 => global."""
    a, kv = full_attention(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                           positions, cfg, window=window)
    h = h + a
    return h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg), kv


# ------------------------------------------------------------ full forward
def forward(params, tokens, cfg: ArchConfig, collect_cache: bool = False,
            last_only: bool = False):
    """Full-sequence forward.  Returns (logits, cache|None).

    ``last_only``: compute logits for the final position only (prefill)."""
    h = _embed(params, tokens, cfg)
    if cfg.family == "ssm":
        return _ssm_forward(params, h, cfg, collect_cache, last_only)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _block_forward(_layer(params["layers"], i), h, positions,
                                   _window(cfg, i), cfg)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache \
        else None
    if last_only:
        h = h[:, -1:, :]
    return _logits(params, h, cfg), cache


def _ssm_forward(params, h, cfg: ArchConfig, collect_cache: bool,
                 last_only: bool):
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        y, st = mamba_forward(lp, rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
                              return_state=collect_cache)
        h = h + y
        if collect_cache:
            convs.append(st[0])
            ssms.append(st[1])
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)} \
        if collect_cache else None
    if last_only:
        h = h[:, -1:, :]
    return _logits(params, h, cfg), cache


# ----------------------------------------------------------------- serving
def prefill(params, batch, cfg: ArchConfig, pad_to: int | None = None):
    """Process the prompt; return (last_logits, cache).

    ``pad_to`` reserves decode slots on axis 2 of the (L,B,T,K,hd) cache;
    the ssm cache has a fixed size and ignores it."""
    tokens = batch["tokens"]
    logits, cache = forward(params, tokens, cfg, collect_cache=True,
                            last_only=True)
    b, seqlen = tokens.shape
    if "k" in cache and pad_to and pad_to > seqlen:
        pad = (0, 0, 0, 0, 0, pad_to - seqlen)   # last dims first: hd, K, T
        cache["k"] = F.pad(cache["k"], pad)
        cache["v"] = F.pad(cache["v"], pad)
    cache["pos"] = torch.full((b,), seqlen, dtype=torch.int64,
                              device=tokens.device)
    return logits[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ArchConfig):
    """One decode step.  tokens (B,1) int.  Returns (logits, cache).

    The cache is updated **in place** -- each layer's new k/v row is written
    into ``cache["k"]``/``cache["v"]`` (or its new conv and ssm states into
    ``cache["conv"]``/``cache["ssm"]``) and ``cache["pos"]`` is incremented
    -- and the same dict is returned (the JAX version returns a new one)."""
    h = params["embed"][tokens[:, :1]].to(dtype_of(cfg.compute_dtype))
    pos = cache["pos"]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            y, (conv, ssm) = mamba_decode(
                lp, rms_norm(h, lp["ln"], cfg.norm_eps), cache["conv"][i],
                cache["ssm"][i], cfg)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
            h = h + y
        pos += 1
        return _logits(params, h, cfg)[:, 0, :], cache
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        a, _ = decode_attention(lp["attn"],
                                rms_norm(h, lp["ln1"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i], pos, cfg,
                                window=_window(cfg, i))
        h = h + a
        h = h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    pos += 1
    return _logits(params, h, cfg)[:, 0, :], cache


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> dict:
    """Fresh (zero) decode cache; the ssm cache does not depend on
    ``max_len``."""
    pos = torch.zeros((batch,), dtype=torch.int64, device=device)
    if cfg.family == "ssm":
        c = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, c),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                                cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=dtype, device=device),
            "pos": pos}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}
