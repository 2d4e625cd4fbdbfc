"""GQA attention: full-sequence (training and prefill), single-token decode
with a KV cache, optional sliding window (gemma3-style local layers), RoPE;
and the encoder-decoder's cross-attention, over a full decoder sequence
(``cross_attention``) or one decode row (``decode_cross_attention``).

Every full-sequence attention goes through ``kernels.flash_attention`` (the
hand-written CUDA kernel for CUDA tensors, its plain version on the CPU):
causal self-attention, the encoder's non-causal self-attention and the
decoder's cross-attention, S decoder rows against the encoder's T keys.  The
kernel computes the reference's masked ``_sdpa`` for each of them (causal is
a parameter of the Pallas kernel, with the diagonal offset T - S).  Decode
attention and decode cross-attention, one query row a step, have no kernel
in the reference and stay plain torch.

In "tp" mode on a mesh whose "model" axis divides the heads
(``common.tp_split``), each rank holds H/nm of the query heads (``wq``'s
columns and ``wo``'s rows, ``launch/shardings.shard_params``) and, when
"model" divides the kv heads too, K/nm of them; Megatron's column and row
split: the input enters through "f" (``copy_to``), flash runs on the rank's
heads against the kv heads they read, ``wo``'s rows give the rank's share
of the output, and "g" (``all_reduce``) sums the shares.  Where ``wk`` and
``wv`` stay whole (fewer kv heads than ranks: GQA at a wide axis, MQA), the
rank projects every kv head and attends with the one its query heads
share; the whole kv weights enter through "f", so their gradients add the
ranks' shares.  Decode caches hold the kv heads the rank projects, as
``launch/shardings.cache_shardings`` lays them out.  In "fsdp" mode the
layer's leaves arrive gathered whole (``common.gather_layer``) and each
rank attends with every head on its own rows, with no collective here;
where a batch smaller than the mesh splits the sequence over the ranks of
some axes (``common.seq_split``: rank r of n holds tokens [r s, (r+1) s)),
the keys and values are gathered over them (``collectives.gather_leaf``,
whose backward sums every rank's share of their gradient) and the rank's s
queries, rotated at their global positions, attend to keys [0, (r+1) s)
through flash with T = (r+1) s: the kernel's diagonal offset T - S is the
rank's start, and a window reaches across the ranks' boundaries."""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ref import NEG_INF
from ..launch.collectives import all_reduce, copy_to, gather_leaf
from ..launch.mesh import coordinate
from .common import apply_rope, normal_init, seq_split, tp_split
from .config import ArchConfig


def init_attn_params(generator, cfg: ArchConfig, dtype, device,
                     lead: tuple = ()) -> dict:
    """``lead`` prepends dims, e.g. (n_layers,) for the stacked layout."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = d ** -0.5
    return {
        "wq": normal_init(generator, (*lead, d, h, hd), std, dtype, device),
        "wk": normal_init(generator, (*lead, d, k, hd), std, dtype, device),
        "wv": normal_init(generator, (*lead, d, k, hd), std, dtype, device),
        "wo": normal_init(generator, (*lead, h, hd, d), (h * hd) ** -0.5,
                          dtype, device),
    }


def _split(params, cfg: ArchConfig):
    """(mesh, params, kv): where "tp" mode splits the heads over "model"
    (``common.tp_split`` of ``wq`` and ``wo``), the mesh and ``params``
    with whole ``wk`` and ``wv`` passed through "f", else (None, params,
    None); kv is the slice of the projected kv heads that this rank's query
    heads read, None (all of them) unless the kv weights are whole.  Query
    heads [r H/nm, (r+1) H/nm) read kv heads h // (H/K); with whole kv
    weights a rank's query heads must share one."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mesh = tp_split("wq", (d, h, hd), params["wq"])
    if mesh is None:
        return None, params, None
    tp_split("wo", (h, hd, d), params["wo"])
    if tp_split("wk", (d, k, hd), params["wk"]) is not None:
        tp_split("wv", (d, k, hd), params["wv"])
        return mesh, params, None
    h_loc, group = params["wq"].shape[-2], h // k
    if group % h_loc or params["wk"].shape[-2] != k:
        raise ValueError(
            f"{cfg.name}: a rank's {h_loc} query heads of {h} must share one "
            f"of the {k} kv heads (groups of {group}) when wk and wv stay "
            f"whole; wq {tuple(params['wq'].shape)}, wk "
            f"{tuple(params['wk'].shape)}")
    kv = coordinate(mesh)["model"] * h_loc // group
    params = {**params, "wk": copy_to(params["wk"], mesh, "model"),
              "wv": copy_to(params["wv"], mesh, "model")}
    return mesh, params, slice(kv, kv + 1)


def _read(kv_heads, kv):
    """The kv heads (B,T,K,hd) that the rank's query heads read."""
    return kv_heads if kv is None else kv_heads[:, :, kv]


def _enter(x, mesh):
    """x into the rank's heads: "f" on a mesh."""
    return x if mesh is None else copy_to(x, mesh, "model")


def _leave(y, mesh):
    """The rank's share of the output summed over "model" ("g")."""
    return y if mesh is None else all_reduce(y, mesh, "model")


def _project(params, x):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    return q, k, v


def _qkv(params, x, positions, cfg: ArchConfig):
    q, k, v = _project(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,K,hd), mask (B,1,S,T) or (1,1,S,T) bool."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    q = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def full_attention(params, x, positions, cfg: ArchConfig, window: int = 0,
                   causal: bool = True):
    """Self-attention over the whole sequence (causal unless ``causal=False``
    for encoder stacks).  ``window`` is a Python int, 0 => global.

    Returns (output, (k, v)) so prefill can seed the decode cache; under
    "tp" the rank's query heads attend and (k, v) are the kv heads it
    projects.  Under a sequence split (``common.seq_split``) ``positions``
    are the rank's global ones and (k, v) are the whole sequence's."""
    mesh, params, kv = _split(params, cfg)
    q, k, v = _qkv(params, _enter(x, mesh), positions, cfg)
    keys, values = k, v
    split = seq_split()
    if split is not None:
        seq_mesh, axes, r, _ = split
        s = k.shape[1]
        k, v = (gather_leaf(t, seq_mesh, 1, axes) for t in (k, v))
        end = (r + 1) * s if causal else k.shape[1]
        keys, values = k[:, :end], v[:, :end]
    out = flash_attention(q, _read(keys, kv), _read(values, kv),
                          causal=causal, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return _leave(y, mesh), (k, v)


def decode_attention(params, x, cache_k, cache_v, pos, cfg: ArchConfig,
                     window: int = 0):
    """One new token per sequence against a cache of static length T.

    x (B,1,D); cache_k/v (B,T,K,hd); pos (B,) int64 -- index of the new
    token (cache positions < pos are valid).  Returns (y, (cache_k,
    cache_v)).  The new row is written into cache_k/v **in place** (JAX's
    ``.at[].set`` returns a copy).  Unlike JAX, which drops an out-of-range
    write silently, a ``pos >= T`` raises: callers keep pos < T."""
    b = x.shape[0]
    t = cache_k.shape[1]
    mesh, params, kv = _split(params, cfg)
    q, k, v = _project(params, _enter(x, mesh))
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos] = k[:, 0]
    cache_v[rows, pos] = v[:, 0]
    cols = torch.arange(t, device=x.device)[None, :]            # (1,T)
    mask = cols <= pos[:, None]
    if window > 0:
        mask &= cols > (pos[:, None] - window)
    out = _sdpa(q, _read(cache_k, kv), _read(cache_v, kv),
                mask[:, None, None, :])
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return _leave(y, mesh), (cache_k, cache_v)


def cross_attention(params, x, enc_k, enc_v, cfg: ArchConfig) -> torch.Tensor:
    """Decoder -> encoder attention of a full decoder sequence x (B,S,D)
    over every encoder position, no RoPE; enc_k/v (B,T,K,hd) precomputed by
    ``encode_kv``.  Non-causal flash attention, S rows against T keys."""
    mesh, params, kv = _split(params, cfg)
    q = torch.einsum("bsd,dhk->bshk", _enter(x, mesh), params["wq"])
    out = flash_attention(q, _read(enc_k, kv), _read(enc_v, kv),
                          causal=False)
    return _leave(torch.einsum("bshk,hkd->bsd", out, params["wo"]), mesh)


def decode_cross_attention(params, x, enc_k, enc_v,
                           cfg: ArchConfig) -> torch.Tensor:
    """``cross_attention`` of one decode row x (B,1,D): plain torch, as
    decode self-attention (a 1-row query would fill one row of the kernel's
    64- or 128-row tiles)."""
    mesh, params, kv = _split(params, cfg)
    q = torch.einsum("bsd,dhk->bshk", _enter(x, mesh), params["wq"])
    mask = torch.ones((1, 1, x.shape[1], enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, _read(enc_k, kv), _read(enc_v, kv), mask)
    return _leave(torch.einsum("bshk,hkd->bsd", out, params["wo"]), mesh)


def encode_kv(params, enc_out, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of the encoder output (B,T,D);
    under "tp" the kv heads this rank projects (its own, or all when the kv
    weights are whole), the encoder output entering through "f"."""
    mesh, params, _ = _split(params, cfg)
    enc_out = _enter(enc_out, mesh)
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"])
    return k, v
