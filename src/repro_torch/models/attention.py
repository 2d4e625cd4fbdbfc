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
rank's start, and a window reaches across the ranks' boundaries.

A decode step's cache lies as ``launch/shardings.cache_shardings`` lays it,
in both modes.  Its kv heads lie over "model" where "model" divides them
(``common.kv_split``): "tp" mode projects the rank's heads as above; in
"fsdp" mode the rank cuts its query and kv heads' slices of the layer's
gathered weights, attends with them and sums y over "model" as "tp" does
(``_heads``; a cache of other kv heads raises).  Where the batch axes do
not divide the batch, its positions lie over them (``common.cache_split``:
rank r of n holds positions [r T/n, (r+1) T/n)): only the rank that holds
``pos`` writes the new row, the mask is built from global positions (a
window included), each rank computes the partial softmax sums of its
positions (``decode_partial``) and the ranks' partials, gathered in rank
order (``collectives.gather_parts``), are combined (``combine_partials``)
alike on every rank; the encoder-decoder's cross-attention cache likewise
where its encoder positions divide them."""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ref import NEG_INF
from ..launch.collectives import (all_reduce, copy_to, gather_leaf,
                                  gather_parts)
from ..launch.mesh import coordinate
from .common import (ambient_mode, apply_rope, cache_split, kv_split,
                     normal_init, seq_split, tp_split)
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


def _heads(params, cfg: ArchConfig, held: int):
    """``_split``'s (mesh, params, kv) for a decode step whose cache holds
    ``held`` kv heads.  In "fsdp" mode, where the cache holds the rank's
    K/nm kv heads (``common.kv_split``), the layer's gathered weights cut
    to the rank's query heads [r H/nm, (r+1) H/nm) and kv heads [r K/nm,
    (r+1) K/nm) (``wq``'s, ``wk``'s and ``wv``'s columns, ``wo``'s rows)
    and the mesh, over whose "model" ranks ``_leave`` sums the shares of
    y.  A cache of other kv heads (an "fsdp" prefill's every head, which
    ``Model.own_heads`` cuts) raises."""
    split = kv_split(cfg) if ambient_mode() == "fsdp" else None
    if split is None:
        return _split(params, cfg)
    mesh, r, nm = split
    k, h = cfg.n_kv_heads // nm, cfg.n_heads // nm
    if held != k:
        raise ValueError(f"a decode cache of {held} kv heads: want the "
                         f"rank's {k} of {cfg.n_kv_heads} "
                         f"(Model.cache_part, Model.own_heads)")
    qs, ks = slice(r * h, (r + 1) * h), slice(r * k, (r + 1) * k)
    return mesh, {"wq": params["wq"][:, qs], "wk": params["wk"][:, ks],
                  "wv": params["wv"][:, ks], "wo": params["wo"][qs]}, None


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


def decode_partial(q, k, v, mask):
    """The partial softmax attention of q (B,S,H,hd) over the positions of
    k/v (B,T,K,hd) that one rank holds, mask (B,1,S,T) or (1,1,S,T) bool:
    (m, l, acc), f32, each (B,K,g,S,.) with g = H/K: m the row maxima of
    the scaled, masked scores (``_sdpa``'s), l the sums of exp(s - m) over
    the unmasked positions and acc the exp(s - m)-weighted sums of v,
    unnormalised, the weights in v's dtype as ``_sdpa``'s probabilities.  A
    part with no unmasked position has l = 0 and acc = 0, and
    ``combine_partials`` weighs it by exp(NEG_INF - max) = 0, not NaN."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    q = q.reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores * (hd ** -0.5)
    keep = mask[:, :, None]
    scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~keep, 0.0)
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), v)
    return m, p.sum(dim=-1, keepdim=True), acc.float()


def combine_partials(m, l, acc) -> torch.Tensor:
    """The attention (B,S,H,hd), f32, of the positions of n parts, from
    their ``decode_partial`` (m, l, acc) stacked in dim 0, (n,B,K,g,S,.):
    each part weighed by exp(m - the largest m), the weighted sums of acc
    over those of l; the same few ops, so the same bits, on every rank."""
    w = torch.exp(m - m.amax(dim=0))
    out = (acc * w).sum(dim=0) / (l * w).sum(dim=0)       # (B,K,g,S,hd)
    b, kh, g, s, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kh * g, hd)


def _context_parallel(q, k, v, mask, split) -> torch.Tensor:
    """``_sdpa`` of keys whose positions lie over the ranks of ``split``'s
    axes (``common.cache_split``): the rank's ``decode_partial``, every
    rank's gathered in rank order, ``combine_partials``, in v's dtype."""
    mesh, axes = split[:2]
    every = gather_parts(torch.cat(decode_partial(q, k, v, mask), dim=-1),
                         mesh, axes)
    return combine_partials(every[..., :1], every[..., 1:2],
                            every[..., 2:]).to(v.dtype)


def _write(cache, row, pos, split) -> None:
    """Row b of ``row`` (B,K,hd) into ``cache`` (B,T,K,hd) at position
    ``pos[b]``, in place; where the positions lie over ranks (``split``),
    at ``pos[b]`` less the rank's start, by the rank that holds it only
    (every other rank writes its row there back unchanged).  A position
    past the last rank's end indexes past every rank's part, so that every
    rank raises alike, as past T does without a split."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if split is None:
        cache[rows, pos] = row
        return
    t, (_, _, r, n) = cache.shape[1], split
    at = torch.where(pos < n * t, (pos - r * t).clamp(0, t - 1), pos)
    own = ((pos >= r * t) & (pos < (r + 1) * t))[:, None, None]
    cache[rows, at] = torch.where(own, row, cache[rows, at])


def decode_attention(params, x, cache_k, cache_v, pos, cfg: ArchConfig,
                     window: int = 0):
    """One new token per sequence against a cache of static length T.

    x (B,1,D); cache_k/v (B,T,K,hd); pos (B,) int64 -- index of the new
    token (cache positions < pos are valid).  Returns (y, (cache_k,
    cache_v)).  The new row is written into cache_k/v **in place** (JAX's
    ``.at[].set`` returns a copy).  Unlike JAX, which drops an out-of-range
    write silently, a ``pos >= T`` raises: callers keep pos < T.  Where the
    positions lie over ranks (``common.cache_split("k")``), cache_k/v are
    the rank's T of them and ``pos`` is global."""
    t = cache_k.shape[1]
    mesh, params, kv = _heads(params, cfg, cache_k.shape[2])
    q, k, v = _project(params, _enter(x, mesh))
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    split = cache_split("k")
    _write(cache_k, k[:, 0], pos, split)
    _write(cache_v, v[:, 0], pos, split)
    start = 0 if split is None else split[2] * t
    cols = start + torch.arange(t, device=x.device)[None, :]    # (1,T)
    mask = cols <= pos[:, None]
    if window > 0:
        mask &= cols > (pos[:, None] - window)
    mask = mask[:, None, None, :]
    keys, values = _read(cache_k, kv), _read(cache_v, kv)
    out = _sdpa(q, keys, values, mask) if split is None else \
        _context_parallel(q, keys, values, mask, split)
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
    64- or 128-row tiles).  enc_k/v hold the rank's kv heads as
    ``decode_attention``'s cache does, and the rank's encoder positions
    where they lie over ranks (``common.cache_split("xk")``)."""
    mesh, params, kv = _heads(params, cfg, enc_k.shape[2])
    q = torch.einsum("bsd,dhk->bshk", _enter(x, mesh), params["wq"])
    mask = torch.ones((1, 1, x.shape[1], enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    keys, values = _read(enc_k, kv), _read(enc_v, kv)
    split = cache_split("xk")
    out = _sdpa(q, keys, values, mask) if split is None else \
        _context_parallel(q, keys, values, mask, split)
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
