"""Encoder-decoder backbone (whisper-medium).

The audio conv frontend is a stub, as in the JAX package: the caller hands
in frame embeddings (B, enc_len, d_model).  The encoder is a non-causal
transformer over the frames; the decoder a causal one with per-layer
cross-attention to the encoder output.  The parameter tree keeps the JAX
package's names and stacked layout (``enc_layers.attn.wq`` is (E,D,H,hd),
``dec_layers.xattn.wq`` (L,D,H,hd)).

    encode(params, frames, cfg)                  -> encoder output (B,T,D)
    dec_forward(params, tokens, enc_out, cfg)    -> logits, cache|None
    train_loss(params, batch, cfg)               -> loss, {"ce"}
    prefill(params, batch, cfg)                  -> last-token logits, cache
    decode_step(params, tokens, cache, cfg)      -> logits (cache in place)

Cache: {"k", "v": (L,B,T,K,hd) self-attention, padded to ``pad_to``;
"xk", "xv": (L,B,enc_len,K,hd) cross-attention; "pos": (B,) int64}.

Every full-sequence attention goes through ``kernels.flash_attention`` (the
hand-written CUDA kernel on the card, forward and backward): the encoder's
non-causal self-attention, the decoder's causal self-attention and its
cross-attention (non-causal, the decoder's S rows against the encoder's T
frames).  A decode step's cross-attention, one row, stays plain torch.
Under autograd each encoder and decoder layer runs under ``cfg.remat``
(``lm._maybe_ckpt``), as the reference's scans do, and the stacked leaves
are unbound once a forward (``lm._unbind``).

In "tp" mode the encoder's, the decoder's and the cross-attention's heads,
the MLPs and the vocabulary are split over "model" as in ``lm``
(``attention``, ``mlp_forward``, ``lm.embed_tokens``, ``lm.ce_loss``);
``encode_kv`` gives the rank's kv heads and ``enc_pos`` stays whole.  In
"fsdp" mode each encoder and decoder layer gathers its leaves whole inside
its remat unit (``common.gather_layer``), and the embedding, ``enc_pos``,
``enc_norm``, ``final_norm`` and the head are gathered at each use, as in
``lm``.

Under a sequence split (an "fsdp" batch smaller than the mesh,
``common.seq_split``) each rank holds a slice of its rows' tokens, and
its rows' frames either split as the tokens are or whole (the rules'
layout of each leaf, ``common.batch_split``: 1500 frames divide no axis
of 16).  Split frames: the encoder runs the rank's frames at their
positions, its attention gathering the keys and values over the frames'
axes, and its output is gathered over them, so that each rank's decoder
slice reads every frame of its rows.  Whole frames: each rank encodes its
rows' whole frames with no split installed (``common.whole_sequence``),
every rank of the sequence's axes alike; each copy takes the gradient of
its own decoder slice, and the step sums them.  The decoder runs the
rank's tokens at their positions, its self-attention as ``lm``'s; a
prefill's last logits, k/v and xk/xv are the whole prompt's on every
rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import (cross_attention, decode_attention,
                        decode_cross_attention, encode_kv, full_attention,
                        init_attn_params)
from ..launch.collectives import gather_leaf, seq_last
from .common import (batch_split, dtype_of, fsdp_whole, gather_layer,
                     gather_layers, gathering, normal_init, own_rows,
                     rms_norm, seq_split, whole_sequence, whole_shapes)
from .config import ArchConfig
from .lm import (_layer, _logits, _maybe_ckpt, _unbind, ce_loss,
                 embed_tokens, kv_heads, seq_positions)
from .mlp import init_mlp_params, mlp_forward


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """Draw the parameter tree (f32 draws cast to ``cfg.param_dtype``); on
    ``device="meta"`` it only describes shapes."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: encdec takes the family 'encdec', not "
                         f"{cfg.family!r}")
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def norms(lead, *names):
        return {n: torch.zeros((*lead, d), dtype=dtype, device=device)
                for n in names}

    def mlp(lead):
        return init_mlp_params(generator, d, cfg.d_ff, cfg.mlp_act, dtype,
                               device, lead=lead)

    enc, dec = (cfg.enc_layers,), (cfg.n_layers,)
    return {
        "embed": normal_init(generator, (cfg.vocab, d), 0.02, dtype, device),
        "enc_pos": normal_init(generator, (cfg.enc_len, d), 0.02, dtype,
                               device),
        "enc_layers": {
            **norms(enc, "ln1", "ln2"),
            "attn": init_attn_params(generator, cfg, dtype, device, lead=enc),
            "mlp": mlp(enc),
        },
        "enc_norm": torch.zeros((d,), dtype=dtype, device=device),
        "dec_layers": {
            **norms(dec, "ln1", "ln2", "ln3"),
            "attn": init_attn_params(generator, cfg, dtype, device, lead=dec),
            "xattn": init_attn_params(generator, cfg, dtype, device,
                                      lead=dec),
            "mlp": mlp(dec),
        },
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": normal_init(generator, (d, cfg.vocab), d ** -0.5, dtype,
                               device),
    }


def _shapes(cfg: ArchConfig) -> dict:
    """Every leaf's whole shape, which "fsdp" mode's gathers read."""
    return whole_shapes(init_params, cfg)


def _enc_layer(lp, h, positions, cfg: ArchConfig):
    """One pre-norm encoder layer: non-causal self-attention and the MLP,
    each with its residual."""
    a, _ = full_attention(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                          positions, cfg, window=0, causal=False)
    h = h + a
    return h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                           cfg.mlp_act, cfg.d_ff)


def _unsplit(fn):
    """``fn`` run with no sequence split (``common.whole_sequence``); inside
    the remat unit, so that the recompute runs the same way."""
    def run(*args):
        with whole_sequence():
            return fn(*args)

    return run


def encode(params, frames, cfg: ArchConfig) -> torch.Tensor:
    """frames (B,T,D) stub embeddings -> encoder output (B,T,D).

    Under a sequence split the output is that of every frame of the
    rank's rows: the rank's frames run at their positions and the output
    is gathered over the frames' axes; frames that lie whole on every rank
    are taken at the rank's rows and run whole (see the module's
    docstring)."""
    d = cfg.d_model
    split = batch_split("frames")
    whole = split is None and seq_split() is not None
    if whole:
        frames = own_rows(frames)
    t = frames.shape[1]
    pos = fsdp_whole("enc_pos", (cfg.enc_len, d), params["enc_pos"])
    start = 0 if split is None else split[2] * t
    h = frames.to(dtype_of(cfg.compute_dtype)) + pos[None, start:start + t]
    positions = torch.arange(start, start + t, device=frames.device)[None]
    fn = gathering(_enc_layer, _shapes(cfg), "enc_layers")
    layer = _maybe_ckpt(_unsplit(fn) if whole else fn, cfg)
    for lp in _unbind(gather_layers(params["enc_layers"], "enc_layers",
                                    _shapes(cfg))):
        h = layer(lp, h, positions, cfg)
    h = rms_norm(h, fsdp_whole("enc_norm", (d,), params["enc_norm"]),
                 cfg.norm_eps)
    return h if split is None else gather_leaf(h, split[0], 1, split[1])


def _dec_layer(lp, h, positions, enc_out, cfg: ArchConfig):
    """One pre-norm decoder layer: causal self-attention, cross-attention
    to ``enc_out`` and the MLP, each with its residual.  Returns (h, (k, v),
    (xk, xv)): the self- and cross-attention keys and values."""
    a, (k, v) = full_attention(lp["attn"],
                               rms_norm(h, lp["ln1"], cfg.norm_eps),
                               positions, cfg, window=0)
    h = h + a
    xk, xv = encode_kv(lp["xattn"], enc_out, cfg)
    h = h + cross_attention(lp["xattn"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                            xk, xv, cfg)
    h = h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln3"], cfg.norm_eps),
                        cfg.mlp_act, cfg.d_ff)
    return h, (k, v), (xk, xv)


def dec_forward(params, tokens, enc_out, cfg: ArchConfig,
                collect_cache: bool = False, last_only: bool = False):
    """The decoder over the whole token sequence.  Returns (logits,
    cache|None); ``last_only``: logits of the final position only.

    Under a sequence split ``tokens`` are the rank's slice, at its
    positions, and ``enc_out`` every frame of the rank's rows (``encode``);
    the last position's logits are the last rank's on every rank, and the
    cache's k/v the whole sequence's."""
    h = embed_tokens(params, tokens, cfg).to(dtype_of(cfg.compute_dtype))
    positions = seq_positions(tokens.shape[1], tokens.device)
    per_layer: dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}
    layer = _maybe_ckpt(gathering(_dec_layer, _shapes(cfg), "dec_layers"),
                        cfg)
    for lp in _unbind(gather_layers(params["dec_layers"], "dec_layers",
                                    _shapes(cfg))):
        h, (k, v), (xk, xv) = layer(lp, h, positions, enc_out, cfg)
        if collect_cache:
            for key, x in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                per_layer[key].append(x)
    cache = ({key: torch.stack(xs) for key, xs in per_layer.items()}
             if collect_cache else None)
    if last_only:
        h = h[:, -1:, :]
        split = seq_split()
        if split is not None:
            h = seq_last(h, split[0], split[1])
    return _logits(params, h, cfg), cache


def train_loss(params, batch, cfg: ArchConfig):
    """Mean CE of the decoder's logits over ``batch["tokens"]`` against
    ``batch["labels"]``, the encoder run over ``batch["frames"]``, as the
    reference's ``train_loss`` (``repro/models/encdec.py:118-122``).
    Returns (loss, {"ce": loss}); differentiate ``loss``."""
    enc_out = encode(params, batch["frames"], cfg)
    logits, _ = dec_forward(params, batch["tokens"], enc_out, cfg)
    loss = ce_loss(logits, batch["labels"], cfg)
    return loss, {"ce": loss}


def prefill(params, batch, cfg: ArchConfig, pad_to: int | None = None):
    """Encode ``batch["frames"]``, run the decoder over ``batch["tokens"]``;
    return (last_logits, cache).  ``pad_to`` reserves decode slots on axis
    2 of ``k``/``v`` (``xk``/``xv`` keep the encoder's length).  Under a
    sequence split every rank returns the whole prompt's."""
    enc_out = encode(params, batch["frames"], cfg)
    logits, cache = dec_forward(params, batch["tokens"], enc_out, cfg,
                                collect_cache=True, last_only=True)
    b, s = batch["tokens"].shape
    split = seq_split()
    if split is not None:           # the rank's slice: the whole prompt's
        s *= split[3]
    if pad_to and pad_to > s:
        pad = (0, 0, 0, 0, 0, pad_to - s)     # last dims first: hd, K, T
        cache["k"] = F.pad(cache["k"], pad)
        cache["v"] = F.pad(cache["v"], pad)
    cache["pos"] = torch.full((b,), s, dtype=torch.int64,
                              device=batch["tokens"].device)
    return logits[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ArchConfig):
    """One decode step.  tokens (B,1) int.  Returns (logits, cache): each
    layer's new k/v row is written into ``cache["k"]``/``cache["v"]`` **in
    place** and ``cache["pos"]`` is incremented (the JAX version returns a
    new cache).  On a mesh the self-attention's and the cross-attention's
    caches may lie split over the ranks' positions, as
    ``launch/steps.make_serve_step`` installs them
    (``attention.decode_attention``, ``decode_cross_attention``)."""
    h = embed_tokens(params, tokens[:, :1], cfg).to(
        dtype_of(cfg.compute_dtype))
    pos = cache["pos"]
    layers = gather_layers(params["dec_layers"], "dec_layers", _shapes(cfg))
    for i in range(cfg.n_layers):
        lp = gather_layer(_layer(layers, i), "dec_layers", _shapes(cfg))
        a, _ = decode_attention(lp["attn"],
                                rms_norm(h, lp["ln1"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i], pos, cfg,
                                window=0)
        h = h + a
        h = h + decode_cross_attention(lp["xattn"],
                                       rms_norm(h, lp["ln2"], cfg.norm_eps),
                                       cache["xk"][i], cache["xv"][i], cfg)
        h = h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln3"], cfg.norm_eps),
                            cfg.mlp_act, cfg.d_ff)
    pos += 1
    return _logits(params, h, cfg)[:, 0, :], cache


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> dict:
    """Fresh (zero) decode cache, with the rank's kv heads on a mesh
    (``lm.kv_heads``) and every row and position."""
    def zeros(t):
        return torch.zeros((cfg.n_layers, batch, t, kv_heads(cfg),
                            cfg.head_dim), dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_len), "xv": zeros(cfg.enc_len),
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}
