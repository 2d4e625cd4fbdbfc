"""Decoder-only LM: the dense family (deepseek, phi4, granite, gemma3), the
MoE family (arctic, llama4-scout), the SSM family (mamba2), the hybrid
(zamba2) and the VLM (llava-next).  The encoder-decoder (whisper) is
``encdec.py``.

One parameter tree with the JAX package's names and its stacked-over-layers
layout (``layers.attn.wq`` is (L, D, H, hd)); the layer loop is a Python
loop over views of the stacked leaves.  Entry points:

    forward(params, tokens, cfg, patches=None) -> logits, aux, cache|None
    train_loss(params, batch, cfg)             -> loss, {"ce", "aux"}
    prefill(params, batch, cfg)                -> last-token logits, cache
    decode_step(params, tokens, cache, cfg)    -> logits (cache in place)

``train_loss`` (with autograd) takes every family of this module; the VLM's
CE covers its text positions only.

Cache layouts (each with "pos": (B,) int64):
    attention families: {"k": (L,B,T,K,hd), "v": ...}
    ssm:                {"conv": (L,B,ck-1,di+2N), "ssm": (L,B,H,N,P)}
    hybrid:             mamba states (nb,pb,B,...) + shared-block KV
                        (nb,B,T,K,hd), nb = L // attn_every, pb = attn_every
On a mesh a rank holds its kv heads, its conv channels and its ssm heads
where ``launch/shardings.cache_shardings`` lays them over "model"
(``kv_heads``, ``state_parts``).

The hybrid's stacked leaves are (nb, pb, ...): block ``b`` runs its pb mamba
layers, then the one ``shared`` attention + MLP block.  The VLM prepends its
projected patches to the token embeddings and then runs the dense stack.

In "tp" mode on a mesh whose "model" axis divides the vocabulary
(``common.tp_split``), ``embed`` and ``lm_head`` hold the rank's slice of it
(rows [r V/nm, (r+1) V/nm)): the embedding looks up the ids the rank holds
(zeros for the others) and "g" sums the ranks' rows; the head takes the
hidden states through "f" and gives the rank's (B, S, V/nm) logits, whose
loss is ``collectives.vocab_cross_entropy`` and whose greedy token
``Model.greedy`` takes.  Tied embeddings use the same slice as the head.
The VLM's ``projector``, split over D, is gathered on use.

In "fsdp" mode every leaf is the rank's slice over the whole mesh: each
layer gathers its leaves whole inside its remat unit (``common.
gather_layer``; the backward reduce-scatters their gradients), a leaf split
on its stacked layer dim is gathered once a forward before the layers are
unbound (``common.gather_layers``), and the embedding, the head,
``final_norm``, the projector and zamba2's shared block are gathered at each
use.  Where a batch smaller than the mesh splits the sequence over the
ranks of some axes (``common.seq_split``), each rank runs its slice of
every row: positions from its start, attention to every earlier token
(``attention.full_attention``), mamba layers from the state the earlier
slices leave (``ssm.py``), the MoE over the reference's blocks
(``mlp.py``); the loss is the mean over the rank's labels, and a
prefill's cache and last logits are the whole sequence's on every rank.
The VLM's ranks hold its patches split as its tokens are, or whole beside
them, and each rank takes one contiguous slice of the patches and tokens
joined, the tail padded where the ranks do not divide them (``_embed``),
so a rank may hold patches only, or pads only; its loss is the sum over
the rank's text positions divided by its count of labels, the rank's
share of the batch's mean.
"""
from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..launch.collectives import (all_reduce, copy_to, gather_leaf,
                                  seq_last, vocab_cross_entropy)
from ..launch.mesh import coordinate
from .attention import decode_attention, full_attention, init_attn_params
from .common import (batch_split, cross_entropy_loss, dtype_of, fsdp_whole,
                     gather_layer, gather_layers, gathering, kv_split,
                     normal_init, own_rows, rms_norm, seq_split, state_split,
                     state_whole, tp_split, tp_whole, whole_shapes)
from .config import ArchConfig
from .mlp import init_mlp_params, init_moe_params, mlp_forward, moe_forward
from .ssm import init_mamba_params, mamba_decode, mamba_forward

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")   # encdec: encdec.py
PATCH_DIM = 1024          # the stub vision tower's patch features
# "dots" remat keeps the outputs of the matrix products (einsum lowers to
# these), as jax.checkpoint_policies.checkpoint_dots keeps dot_general's
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: lm takes the families {FAMILIES}, not "
                         f"{cfg.family!r}")


# --------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device) -> dict:
    """Draw the parameter tree leaf by leaf (f32 draws, cast to
    ``cfg.param_dtype``; the MoE router and mamba's ``A_log``, ``D`` and
    ``dt_bias`` stay f32).  On ``device="meta"`` it
    only describes shapes."""
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
    if cfg.family in ("ssm", "hybrid"):
        lead = _lead(cfg)
        params["layers"] = init_mamba_params(generator, cfg, dtype, device,
                                             lead=lead)
        params["layers"]["ln"] = torch.zeros((*lead, d), dtype=dtype,
                                             device=device)
        if cfg.family == "hybrid":
            params["shared"] = _init_block(generator, cfg, dtype, device)
        return params
    params["layers"] = _init_block(generator, cfg, dtype, device,
                                   lead=(n,))
    if cfg.family == "vlm":
        params["projector"] = normal_init(generator, (PATCH_DIM, d),
                                          PATCH_DIM ** -0.5, dtype, device)
    return params


def _init_block(generator, cfg: ArchConfig, dtype, device,
                lead: tuple = ()) -> dict:
    """Transformer blocks (attention + MLP or MoE), stacked over ``lead``."""
    d = cfg.d_model
    block = {
        "ln1": torch.zeros((*lead, d), dtype=dtype, device=device),
        "ln2": torch.zeros((*lead, d), dtype=dtype, device=device),
        "attn": init_attn_params(generator, cfg, dtype, device, lead=lead),
    }
    if not cfg.n_experts:
        block["mlp"] = init_mlp_params(generator, d, cfg.d_ff, cfg.mlp_act,
                                       dtype, device, lead=lead)
        return block
    block["moe"] = init_moe_params(generator, cfg, dtype, device, lead=lead)
    if cfg.moe_dense_ff:
        block["dense_mlp"] = init_mlp_params(
            generator, d, cfg.moe_dense_ff, cfg.mlp_act, dtype, device,
            lead=lead)
    if cfg.shared_expert_ff:
        block["shared_mlp"] = init_mlp_params(
            generator, d, cfg.shared_expert_ff, cfg.mlp_act, dtype, device,
            lead=lead)
    return block


def _lead(cfg: ArchConfig) -> tuple:
    """The stacked axes of ``params["layers"]``: (L,), or (nb, pb) for the
    hybrid's mamba layers."""
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    return (cfg.n_layers,)


# ----------------------------------------------------------------- helpers
def _shapes(cfg: ArchConfig) -> dict:
    """Every leaf's whole shape, which "fsdp" mode's gathers read."""
    return whole_shapes(init_params, cfg)


def _unbind(tree: dict) -> list[dict]:
    """The per-layer trees of the stacked leaves, each leaf unbound once.
    Under autograd the unbind's backward stacks the layers' gradients once,
    where indexing each layer would add a zero gradient of the whole leaf
    per layer."""
    parts = {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _layer(tree: dict, *idx: int) -> dict:
    """Views of layer ``idx`` of the stacked leaves: ``(i,)``, or ``(b, j)``
    over the hybrid's two stacked axes."""
    return {k: _layer(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _window(cfg: ArchConfig, i: int) -> int:
    return 0 if cfg.is_global_layer(i) else cfg.sliding_window


def vocab_mesh(cfg: ArchConfig, embed: torch.Tensor | None = None):
    """The mesh over whose "model" ranks "tp" mode splits the vocabulary
    (``common.tp_split`` of ``embed``, whose rows the rule splits by the
    same test as ``lm_head``'s columns), else None; given ``embed``, the
    rank's leaf, checks its share."""
    return tp_split("embed", (cfg.vocab, cfg.d_model), embed)


def _logits(params, h, cfg: ArchConfig):
    """The logits (B,S,V) of the final hidden states; under "tp", the
    rank's vocabulary slice (B,S,V/nm)."""
    d, v = cfg.d_model, cfg.vocab
    h = rms_norm(h, fsdp_whole("final_norm", (d,), params["final_norm"]),
                 cfg.norm_eps)
    if cfg.tie_embeddings:
        head = fsdp_whole("embed", (v, d), params["embed"]).T
        mesh = vocab_mesh(cfg, params["embed"])
    else:
        head = fsdp_whole("lm_head", (d, v), params["lm_head"])
        mesh = tp_split("lm_head", (d, v), head)
    if mesh is not None:
        h = copy_to(h, mesh, "model")
    return torch.einsum("bsd,dv->bsv", h, head)


def ce_loss(logits, labels, cfg: ArchConfig,
            count: int | None = None) -> torch.Tensor:
    """Mean CE of ``_logits``' output: ``cross_entropy_loss``, over the
    vocabulary's slices under "tp"; with ``count``, the sum over the
    positions divided by it."""
    mesh = vocab_mesh(cfg)
    if mesh is None:
        return cross_entropy_loss(logits, labels, count=count)
    loss = vocab_cross_entropy(logits, labels, mesh)
    return loss if count is None else loss * (labels.numel() / count)


def embed_tokens(params, tokens, cfg: ArchConfig) -> torch.Tensor:
    """``embed``'s rows of ``tokens``, in the parameters' dtype; under "tp"
    each rank looks up the ids of its vocabulary slice, zeros for the
    others, and the ranks' rows are summed."""
    mesh = vocab_mesh(cfg, params["embed"])
    if mesh is None:
        return fsdp_whole("embed", (cfg.vocab, cfg.d_model),
                          params["embed"])[tokens]
    part = params["embed"].shape[0]
    v0 = coordinate(mesh)["model"] * part
    own = (tokens >= v0) & (tokens < v0 + part)
    rows = params["embed"][torch.where(own, tokens - v0, 0)]
    return all_reduce(rows.masked_fill(~own[..., None], 0), mesh, "model")


def _joined_length(tokens, patches, cfg: ArchConfig) -> int:
    """The real positions of the whole sequence: the VLM's patches, then
    the tokens.  Under a sequence split ``tokens`` are the rank's slice of
    its rows' (so are the patches where ``batch_split("patches")`` says
    they are split as the tokens are; else they lie whole)."""
    split = seq_split()
    n = 1 if split is None else split[3]
    size = tokens.shape[1] * n
    if cfg.family == "vlm":
        size += patches.shape[1] * (1 if batch_split("patches") is None
                                    else n)
    return size


def _embed(params, tokens, cfg: ArchConfig, patches=None):
    """Token embeddings; the VLM prepends its ``patches`` (B,P,1024) through
    the projector, in the parameters' dtype.

    Under a sequence split of n slices the VLM's rank holds one contiguous
    slice of the joined sequence of L positions (``_joined_length``),
    [r s, (r+1) s) with s = ceil(L / n), which flash's causal offset and
    ``seq_positions`` read.  The token embeddings are gathered over the
    sequence's axes, and so are the projected patches where they are split
    as the tokens are; patches that lie whole on every rank (every row's:
    the rank's rows are cut) are projected whole on every rank.  Patches
    and tokens are joined, padded at the tail with zeros to n s positions
    and cut; the gathers' backward reduce-scatters their gradients, and
    the projector's gradient is the sum of each rank's own positions'.
    The pads follow every real position, so a real position's causal
    attention never reads one."""
    split = seq_split()
    if cfg.family == "vlm" and patches is None:
        raise ValueError("vlm needs patch embeddings")
    h = embed_tokens(params, tokens, cfg)
    if cfg.family == "vlm":
        whole = (PATCH_DIM, cfg.d_model)
        proj = fsdp_whole("projector", whole, tp_whole(
            "projector", whole, params["projector"]))
        kept = split is not None and batch_split("patches") is None
        pe = torch.einsum("bpv,vd->bpd", (own_rows(patches) if kept
                                          else patches).to(h.dtype), proj)
        if split is None:
            h = torch.cat([pe, h], dim=1)
        else:
            mesh, axes, r, n = split
            if not kept:
                pe = gather_leaf(pe, mesh, 1, axes)
            h = torch.cat([pe, gather_leaf(h, mesh, 1, axes)], dim=1)
            size = -(-h.shape[1] // n)
            if size * n > h.shape[1]:
                h = F.pad(h, (0, 0, 0, size * n - h.shape[1]))
            h = h.narrow(1, r * size, size)
    return h.to(dtype_of(cfg.compute_dtype))


def _ffn(lp, m, cfg: ArchConfig):
    """The block's feed-forward half: the MLP, or the MoE plus arctic's
    dense residual FFN and llama4's shared expert.  Returns (y, aux): the
    MoE's load-balancing loss, an f32 scalar, or None for the MLP."""
    if not cfg.n_experts:
        return mlp_forward(lp["mlp"], m, cfg.mlp_act, cfg.d_ff), None
    y, aux = moe_forward(lp["moe"], m, cfg)
    if cfg.moe_dense_ff:
        y = y + mlp_forward(lp["dense_mlp"], m, cfg.mlp_act,
                            cfg.moe_dense_ff)
    if cfg.shared_expert_ff:
        y = y + mlp_forward(lp["shared_mlp"], m, cfg.mlp_act,
                            cfg.shared_expert_ff)
    return y, aux


def _maybe_ckpt(fn, cfg: ArchConfig):
    """``cfg.remat`` under autograd, as the reference's ``_maybe_ckpt``
    (``repro/models/lm.py:105-111``): "full" keeps only each block's inputs
    and recomputes the block in the backward, "dots" also keeps its matrix
    products' outputs.  Without grad nothing is kept, and ``fn`` runs as
    is.  On the meta device (the dry run) no RNG state is stashed: no block
    draws random numbers, and meta has no generator."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _DOTS)}
    else:
        raise ValueError(f"remat {cfg.remat!r}: want none, full or dots")

    def run(*args):
        meta = any(isinstance(a, torch.Tensor) and a.is_meta for a in args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=not meta, **kw)

    return run


def _mamba_layer(lp, h, cfg: ArchConfig, collect: bool):
    """One pre-norm mamba layer with its residual.  Returns (h, (conv_state,
    ssm_state) or None)."""
    y, st = mamba_forward(lp, rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
                          return_state=collect)
    return h + y, st


def _hybrid_block(blk, shared, h, positions, cfg: ArchConfig,
                  collect: bool):
    """One hybrid block: its pb mamba layers (``blk``, a list of layer
    trees), then the shared attention + MLP block.  Returns (h, the mamba
    states, (k, v))."""
    shapes = _shapes(cfg)
    sts = []
    for lp in blk:
        h, st = _mamba_layer(gather_layer(lp, "layers", shapes, 2), h, cfg,
                             collect)
        sts.append(st)
    h, _, kv = _block_forward(gather_layer(shared, "shared", shapes, 0), h,
                              positions, 0, cfg)
    return h, sts, kv


def _block_forward(lp, h, positions, window: int, cfg: ArchConfig):
    """One transformer block on a full sequence; window 0 => global.
    Returns (h, aux or None, (k, v))."""
    a, kv = full_attention(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                           positions, cfg, window=window)
    h = h + a
    y, aux = _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    return h + y, aux, kv


def seq_positions(n: int, device) -> torch.Tensor:
    """(1, n): the positions of a sequence of ``n`` tokens, from the rank's
    start where a sequence split holds it (``common.seq_split``: rank r of
    the slices of ``n`` tokens starts at r n)."""
    split = seq_split()
    start = 0 if split is None else split[2] * n
    return torch.arange(start, start + n, device=device)[None, :]


# ------------------------------------------------------------ full forward
def forward(params, tokens, cfg: ArchConfig, collect_cache: bool = False,
            last: int = 0, patches=None, text: int = 0):
    """Full-sequence forward.  Returns (logits, aux, cache|None); aux is the
    MoE load-balancing loss summed over the layers in layer order, in f32
    (0 for the other families), as the reference's scan carry sums it.

    ``last > 0``: logits of the last ``last`` positions only (1 for prefill);
    the final norm and the head act per position, so these are the full
    logits' last rows.  ``text > 0``: logits of the positions among the
    whole sequence's last ``text`` (the VLM's text, for its loss) that the
    rank holds.  ``patches``: the VLM's (B,P,1024) patch features,
    prepended.

    Under a sequence split (``common.seq_split``) ``tokens`` are the rank's
    slice: the logits are its positions' (the VLM's padded tail included,
    ``_embed``), the last ``last`` real ones (at most those of the rank
    that holds the last) that rank's on every rank, those of ``text`` the
    rank's own (none on a rank of patches or pads only), and the cache's
    k/v the whole padded sequence's."""
    h = _embed(params, tokens, cfg, patches)
    split = seq_split()
    positions = seq_positions(h.shape[1], h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    per_layer: dict[str, list] = {}

    def keep(**states):
        if collect_cache:
            for key, x in states.items():
                per_layer.setdefault(key, []).append(x)

    shapes = _shapes(cfg)
    layers = gather_layers(params["layers"], "layers", shapes,
                           len(_lead(cfg)))
    if cfg.family == "ssm":
        layer = _maybe_ckpt(gathering(_mamba_layer, shapes, "layers"), cfg)
        for lp in _unbind(layers):
            h, st = layer(lp, h, cfg, collect_cache)
            if collect_cache:
                keep(conv=st[0], ssm=st[1])
    elif cfg.family == "hybrid":
        block = _maybe_ckpt(_hybrid_block, cfg)
        for blk in _unbind(layers):
            h, sts, (k, v) = block(_unbind(blk), params["shared"], h,
                                   positions, cfg, collect_cache)
            for st in sts if collect_cache else ():
                keep(conv=st[0], ssm=st[1])
            keep(k=k, v=v)
    else:
        block = _maybe_ckpt(gathering(_block_forward, shapes, "layers"), cfg)
        for i, lp in enumerate(_unbind(layers)):
            h, a, (k, v) = block(lp, h, positions, _window(cfg, i), cfg)
            if a is not None:
                aux = aux + a
            keep(k=k, v=v)
    cache = None
    if collect_cache:
        cache = {key: torch.stack(xs) for key, xs in per_layer.items()}
        for key in ("conv", "ssm"):
            if key in cache:      # (nb * pb, ...) -> (nb, pb, ...)
                cache[key] = cache[key].unflatten(0, _lead(cfg))
    if split is None:
        if last > 0:
            h = h[:, -last:, :]
        elif text > 0:
            h = h[:, h.shape[1] - text:, :]
    elif last > 0 or text > 0:
        mesh, axes, r, _ = split
        s, size = h.shape[1], _joined_length(tokens, patches, cfg)
        if last > 0:    # every rank takes `last` rows: seq_last stacks them
            end = min(max(size - r * s, last), s)
            h = seq_last(h.narrow(1, end - last, last), mesh, axes,
                         (size - 1) // s)
        else:
            lo, hi = (min(max(x - r * s, 0), s) for x in (size - text, size))
            h = h[:, lo:hi, :]
    return _logits(params, h, cfg), aux, cache


# ------------------------------------------------------------------- train
def train_loss(params, batch, cfg: ArchConfig):
    """Mean CE of the logits of ``batch["tokens"]`` against
    ``batch["labels"]`` plus 0.01 * the MoE aux loss (0 for the other
    families), as the reference's ``train_loss`` (``repro/models/lm.py:
    224-232``).  Returns (total, {"ce", "aux"}); differentiate ``total``.
    The VLM runs ``batch["patches"]`` before the tokens and takes CE on the
    last ``labels.shape[1]`` positions only, the text, as the reference's
    ``logits[:, -labels.shape[1]:]`` does; the head runs on those alone.

    Under a sequence split the VLM's ranks hold other numbers of text
    positions (``_embed``; none on a rank of patches only): each rank's
    labels are cut anew from its rows' gathered over the sequence's axes,
    to its own text positions, and its CE is their sum divided by its
    count of labels, so that the mean over the ranks, which the step
    takes, is the batch's mean."""
    labels = batch["labels"]
    split = seq_split() if cfg.family == "vlm" else None
    text = 0 if cfg.family != "vlm" else \
        labels.shape[1] * (1 if split is None else split[3])
    logits, aux, _ = forward(params, batch["tokens"], cfg,
                             patches=batch.get("patches"), text=text)
    if split is None:
        loss = ce_loss(logits, labels, cfg)
    else:
        mesh, axes, r, n = split
        every = gather_leaf(labels, mesh, 1, axes)            # (B, S)
        size = _joined_length(batch["tokens"], batch["patches"], cfg)
        p = size - text
        first = min(max(r * -(-size // n), p) - p, text)
        loss = ce_loss(logits, every.narrow(1, first, logits.shape[1]), cfg,
                       count=labels.numel())
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ----------------------------------------------------------------- serving
def prefill(params, batch, cfg: ArchConfig, pad_to: int | None = None):
    """Process the prompt (the VLM's patches first); return (last_logits,
    cache).  Under a sequence split the cache's k/v hold the whole prompt's
    positions, the VLM's padded tail (``_embed``) cut off.

    ``pad_to`` reserves decode slots on axis 2 of the (L,B,T,K,hd) or
    (nb,B,T,K,hd) cache; the mamba states have a fixed size and ignore it."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    logits, _, cache = forward(params, tokens, cfg, collect_cache=True,
                               last=1, patches=patches)
    b = tokens.shape[0]
    seqlen = _joined_length(tokens, patches, cfg)   # the whole prompt's
    if "k" in cache and cache["k"].shape[2] > seqlen:   # the padded tail
        cache["k"] = cache["k"][:, :, :seqlen].contiguous()
        cache["v"] = cache["v"][:, :, :seqlen].contiguous()
    if "k" in cache and pad_to and pad_to > seqlen:
        pad = (0, 0, 0, 0, 0, pad_to - seqlen)   # last dims first: hd, K, T
        cache["k"] = F.pad(cache["k"], pad)
        cache["v"] = F.pad(cache["v"], pad)
    cache["pos"] = torch.full((b,), seqlen, dtype=torch.int64,
                              device=tokens.device)
    return logits[:, -1, :], cache


def _block_decode(lp, h, cache_k, cache_v, pos, window: int,
                  cfg: ArchConfig):
    """One transformer block on one new token; k/v rows written in place."""
    a, _ = decode_attention(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                            cache_k, cache_v, pos, cfg, window=window)
    h = h + a
    return h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)[0]


def decode_step(params, tokens, cache, cfg: ArchConfig):
    """One decode step.  tokens (B,1) int.  Returns (logits, cache).

    The cache is updated **in place** -- each layer's new k/v row is written
    into ``cache["k"]``/``cache["v"]`` (and each mamba layer's new conv and
    ssm states into ``cache["conv"]``/``cache["ssm"]``) and ``cache["pos"]``
    is incremented -- and the same dict is returned (the JAX version returns
    a new one).  On a mesh the cache is the rank's part in the layout
    ``launch/steps.make_serve_step`` installs: where its positions lie over
    ranks (a batch of one), each attention layer -- gemma3's windowed ones
    and the hybrid's shared block included -- writes and attends at the
    rank's global positions (``attention.decode_attention``); the mamba
    states, which have no positions, lie over "model" as for any batch:
    each rank holds its channels of the conv state and its heads of the
    ssm state (``ssm.mamba_decode``)."""
    h = embed_tokens(params, tokens[:, :1], cfg).to(
        dtype_of(cfg.compute_dtype))
    pos = cache["pos"]
    shapes = _shapes(cfg)
    lead = _lead(cfg)
    layers = gather_layers(params["layers"], "layers", shapes, len(lead))
    if cfg.family in ("ssm", "hybrid"):
        for idx in itertools.product(*map(range, lead)):
            lp = gather_layer(_layer(layers, *idx), "layers", shapes,
                              len(lead))
            y, (conv, ssm) = mamba_decode(
                lp, rms_norm(h, lp["ln"], cfg.norm_eps), cache["conv"][idx],
                cache["ssm"][idx], cfg)
            cache["conv"][idx].copy_(conv)
            cache["ssm"][idx].copy_(ssm)
            h = h + y
            if cfg.family == "hybrid" and idx[1] == cfg.attn_every - 1:
                h = _block_decode(gather_layer(params["shared"], "shared",
                                               shapes, 0), h,
                                  cache["k"][idx[0]], cache["v"][idx[0]],
                                  pos, 0, cfg)
    else:
        for i in range(cfg.n_layers):
            h = _block_decode(gather_layer(_layer(layers, i), "layers",
                                           shapes), h, cache["k"][i],
                              cache["v"][i], pos, _window(cfg, i), cfg)
    pos += 1
    return _logits(params, h, cfg)[:, 0, :], cache


def kv_heads(cfg: ArchConfig) -> int:
    """The kv heads a rank's decode cache holds: K/nm where
    ``cache_shardings`` lays them over "model" (``common.kv_split``), in
    both modes, else all K."""
    split = kv_split(cfg)
    return cfg.n_kv_heads if split is None else cfg.n_kv_heads // split[2]


def state_parts(cfg: ArchConfig) -> tuple[int, int]:
    """(channels, heads): the conv channels and ssm heads a rank's decode
    cache holds: (di + 2N) / nm and H / nm where ``cache_shardings`` lays
    them over "model" (``common.state_split``), in both modes, else all
    of them."""
    out = []
    for key, (_, n) in state_whole(cfg).items():
        split = state_split(cfg, key)
        out.append(n if split is None else n // split[2])
    return tuple(out)


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> dict:
    """Fresh (zero) decode cache; the mamba states do not depend on
    ``max_len``.  On a mesh the kv heads, the conv channels and the ssm
    heads are the rank's (``kv_heads``, ``state_parts``) and every row and
    every position is kept (the serving engine's, alike on every rank;
    ``Model.cache_part`` cuts a rank's part)."""
    cache = {"pos": torch.zeros((batch,), dtype=torch.int64, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        lead = _lead(cfg)
        c, h = state_parts(cfg)
        cache["conv"] = torch.zeros((*lead, batch, cfg.ssm_conv - 1, c),
                                    dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((*lead, batch, h, cfg.ssm_state,
                                    cfg.ssm_head_dim),
                                   dtype=dtype, device=device)
    if cfg.family != "ssm":
        n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                  else cfg.n_layers)
        shape = (n_attn, batch, max_len, kv_heads(cfg), cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
