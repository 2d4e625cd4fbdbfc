"""Feed-forward blocks: SwiGLU/GELU MLP and capacity-based top-k MoE.

The MoE block scatters tokens into per-expert capacity buffers (B,E,C,D),
runs the grouped expert FFN on them (``kernels.moe_gmm``: the hand-written
CUDA kernels for CUDA tensors, their plain versions on the CPU) and gathers
the results back.  On one process that is the reference's dense dispatch.
Under a mesh (``common.use_mesh``) whose "model" axis divides the experts,
each rank holds E/nm experts (``launch/shardings.shard_params``) and runs
one of the reference's two expert-parallel paths, with the collectives of
``launch/collectives.py``:

    _moe_expert_parallel      ("tp", the default) every rank routes its
                              whole block, runs its experts' share, and an
                              all-reduce over "model" sums the shares
    _moe_expert_parallel_a2a  ("fsdp", when "model" divides the sequence)
                              every rank routes its slice of the sequence,
                              an all-to-all ships the slots to the experts'
                              ranks and another one back

A rank's block is the rows of the batch that ``shard_batch`` gave it (the
whole batch when the rows do not divide the data axes), as the reference's
``shard_map`` block, so its capacity, slot order and buffers are the
reference's.  Unlike the reference, the load-balancing ``aux`` is the whole
batch's at any mesh (ROADMAP.md, faults of the reference).

An "fsdp" training step splits the rows over "model" too (``use_mesh``'s
``rows``, which ``Model.train_loss`` installs; serving keeps the rows the
engine gives, alike on every rank of "model").  Then the all-to-all path
first exchanges the rank's rows for its data group's rows at its slice of
the sequence (the reference's ``in_specs`` ``P(bspec, "model")``) and
exchanges them back at the end; the all-reduce path routes the rank's rows,
gathers the rows and their routing over "model" and reduce-scatters the
experts' shares back to the rows' ranks; the router, gathered whole by the
layer (``common.gather_layer``), enters no "f": its reduce-scatter already
sums every rank's share.

An "fsdp" batch smaller than the mesh splits each row's sequence over the
axes its rows leave (``common.seq_split``), "model" always among them:
the all-to-all path routes the reference's block, which is the rank's
part where the rows divide the data axes and is gathered and cut from the
ranks' parts where they do not (``_moe_a2a_seq``); the dense dispatch
keeps each row's capacity and slots over its whole sequence (``_route``'s
``split``).

In "tp" mode the MLP (the dense one, arctic's ``dense_mlp``, llama4's
``shared_mlp``, whisper's and zamba2's shared block's) is Megatron's column
and row split over "model" where it divides the hidden dim
(``common.tp_split``): the input through "f", the rank's columns of ``w_in``
and ``w_gate``, the activation on its hidden slice, its rows of ``w_out``,
and "g" over the ranks' shares.  Experts fewer than the "model" axis are
split the same way over their hidden dim, in the dense dispatch."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import grouped_ffn
from ..launch.collectives import (all_reduce, all_to_all, copy_to,
                                  gather_leaf, scatter_sum, seq_gather,
                                  seq_slice)
from ..launch.mesh import MeshSpec, batch_axes, coordinate
from .common import (ambient_mesh, ambient_mode, ambient_rows, ambient_seq,
                     normal_init, seq_rank, seq_split, tp_split)
from .config import ArchConfig


def init_mlp_params(generator, d: int, ff: int, act: str, dtype, device,
                    lead: tuple = ()) -> dict:
    p = {
        "w_in": normal_init(generator, (*lead, d, ff), d ** -0.5, dtype,
                            device),
        "w_out": normal_init(generator, (*lead, ff, d), ff ** -0.5, dtype,
                             device),
    }
    if act == "swiglu":
        p["w_gate"] = normal_init(generator, (*lead, d, ff), d ** -0.5, dtype,
                                  device)
    return p


def mlp_forward(params, x, act: str, ff: int) -> torch.Tensor:
    """SwiGLU or GELU MLP of x (B,S,D); ``ff`` is its whole hidden width,
    which with D gives the whole leaves' shapes, by which "tp" mode knows
    (``common.tp_split``) whether the leaves hold the rank's hidden slice
    (then the output is summed over "model")."""
    d = x.shape[-1]
    mesh = tp_split("w_in", (d, ff), params["w_in"])
    if mesh is not None:
        tp_split("w_out", (ff, d), params["w_out"])
        x = copy_to(x, mesh, "model")
    h = torch.einsum("bsd,df->bsf", x, params["w_in"])
    if act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    y = torch.einsum("bsf,fd->bsd", h, params["w_out"])
    return y if mesh is None else all_reduce(y, mesh, "model")


def init_moe_params(generator, cfg: ArchConfig, dtype, device,
                    lead: tuple = ()) -> dict:
    """The router is f32 whatever ``dtype`` is, as in the reference."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": normal_init(generator, (*lead, d, e), d ** -0.5,
                              torch.float32, device),
        "w_in": normal_init(generator, (*lead, e, d, ff), d ** -0.5, dtype,
                            device),
        "w_gate": normal_init(generator, (*lead, e, d, ff), d ** -0.5, dtype,
                              device),
        "w_out": normal_init(generator, (*lead, e, ff, d), ff ** -0.5, dtype,
                             device),
    }


def moe_capacity(cfg: ArchConfig, tokens_per_row: int) -> int:
    c = math.ceil(cfg.capacity_factor * tokens_per_row * cfg.top_k
                  / cfg.n_experts)
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) spelled the same on every device:
    ``F.one_hot`` checks the range on the CPU, scatters on the card and
    compares on meta, so a step's counted work would differ between them."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_forward(params, x, cfg: ArchConfig):
    """Top-k capacity-dispatch MoE.  x (B,S,D) -> (y, aux_loss).

    Per batch row (per slice of a row in the all-to-all path), each expert
    takes at most ``moe_capacity`` of the routed (token, choice) pairs, in
    (S, k) order; the rest are dropped (weight 0).  ``aux_loss`` is the
    Switch load-balancing loss.  The path is chosen as the reference's
    ``moe_forward`` chooses it (``repro/models/mlp.py:69-79``), without its
    ``kernel_mode`` condition: the port has no kernel mode.  Under a
    sequence split x is the rank's slice of its rows, and the test is on
    the whole sequence's length."""
    mesh = ambient_mesh()
    if mesh is None:
        return _moe_dense_dispatch(params, x, cfg)
    nm = MeshSpec.of(mesh).shape.get("model", 0)
    if nm and cfg.n_experts % nm == 0:
        split = seq_split()
        seq = x.shape[1] * (1 if split is None else split[3])
        if ambient_mode() == "fsdp" and seq % nm == 0:
            return _moe_expert_parallel_a2a(params, x, cfg, mesh)
        return _moe_expert_parallel(params, x, cfg, mesh)
    return _moe_dense_dispatch(params, x, cfg, mesh)


def _route(x, router, cfg: ArchConfig, cap: int, split=None):
    """Route the tokens of x (B,S,D): the softmax probabilities (B,S,E),
    the top-k expert ids (B,S,k), and per (row, token, choice) in (S, k)
    order the expert (B,S*k), its slot, whether it fits the capacity and
    its combine weight (renormalised top-k probability, 0 if dropped).

    ``split`` (``common.seq_split``): x is the rank's slice of its rows'
    sequence, and a pair fits where its slot over the row's whole sequence
    does, the pairs of the earlier slices first (``_earlier``); the slot
    returned is the one among the slice's own pairs, less than S."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                        # (B,S,E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (B,S,k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_i.reshape(b, s * k)                             # (B,T)
    onehot = _one_hot(flat_e, e)                                 # (B,T,E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    slot = pos_in_e.gather(-1, flat_e[..., None])[..., 0]        # (B,T)
    keep = slot < cap
    if split is not None:
        keep = slot + _earlier(onehot.sum(dim=1), split).gather(
            -1, flat_e) < cap
    slot = torch.where(keep, slot, 0)
    w = top_p.reshape(b, s * k) * keep                           # (B,T)
    return probs, top_i, flat_e, slot, keep, w


def _earlier(counts, split):
    """(B, E): each row's pairs of each expert in the slices of its
    sequence before the rank's, from every rank's ``counts`` (B, E) of its
    own, gathered over the sequence's axes (integers: no gradient).  Every
    rank gathers, the first too."""
    mesh, axes, index, _ = split
    return gather_leaf(counts[None], mesh, 0, axes)[:index].sum(dim=0)


def _token_axes(mesh) -> tuple:
    """The axes whose ranks hold other tokens: the rows' and the
    sequence's, in the mesh's order."""
    held = (*ambient_rows(), *ambient_seq())
    return tuple(a for a in MeshSpec.of(mesh).axis_names if a in held)


def _aux(probs, top_i, e: int, mesh=None, axes: tuple = (),
         n_summed: int = 1):
    """The Switch load-balancing loss e * sum(me * ce): me the mean routing
    probability of each expert, ce the share of first choices.

    Under a mesh, me and ce are means over every rank of ``axes``, the
    ranks that hold other tokens, so aux is the whole batch's.  The
    gradient each rank keeps of me is its share as the training step
    counts it: ``make_train_step`` averages the gradients over the row
    axes, which takes the full derivative on each, and the shares of the
    ``n_summed`` ranks of "model" that split the sequence of the same rows
    add up in the slice's backward."""
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = _one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    if mesh is not None:
        n = math.prod(MeshSpec.of(mesh).shape[a] for a in axes)
        mc = all_reduce(torch.stack([me, ce]), mesh, axes,
                        grad_scale=n / n_summed) / n
        me, ce = mc[0], mc[1]
    return e * torch.sum(me * ce)


def _dispatch(x, flat_e, slot, gate, n_experts: int, cap: int, k: int):
    """Scatter the (token, choice) pairs of x (B,S,D) whose ``gate`` is set
    into (B, n_experts, cap, D); returns it and the row index of each pair.
    Each gated (b, e, slot) gets exactly one token, the others add exact
    zeros at slot 0, so the sum is order-free."""
    b, s, d = x.shape
    x_tok = torch.repeat_interleave(x, k, dim=1)                 # (B,T,D)
    buf = torch.zeros((b, n_experts, cap, d), dtype=x.dtype, device=x.device)
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf.index_put_((b_idx, flat_e, slot), x_tok * gate[..., None].to(x.dtype),
                   accumulate=True)
    return buf, b_idx


def _combine(h, b_idx, flat_e, slot, w, k: int):
    """Gather each pair's expert output from h and sum a token's choices
    with weights ``w``: (B, S, D)."""
    y_tok = h[b_idx, flat_e, slot] * w[..., None].to(h.dtype)    # (B,T,D)
    b, t, d = y_tok.shape
    return y_tok.reshape(b, t // k, k, d).sum(dim=2)


def _experts(params, buf, cfg: ArchConfig, tokens: int):
    """The grouped FFN on buf, which holds some of the pairs of ``tokens``
    routed tokens: B·S·k pairs at most, which a counter books
    (``grouped_ffn``'s ``pairs``)."""
    return grouped_ffn(buf, params["w_in"], params["w_gate"],
                       params["w_out"], cfg.mlp_act, tokens * cfg.top_k)


def _moe_dense_dispatch(params, x, cfg: ArchConfig, mesh=None):
    """One process's dispatch over every expert (or, under a mesh whose
    "model" axis does not divide the experts, each rank's over every
    expert, aux over the axes whose ranks hold other tokens: the experts
    whole, or in "tp" mode their hidden slice, the tokens and combine
    weights then entering through "f" and the ranks' shares of y summed).

    Under a sequence split (``common.seq_split``) this is the reference's
    GSPMD dispatch of the whole rows: the capacity is the whole sequence's
    and a pair's slot counts over the row's whole sequence (``_route``),
    so the pairs kept are one process's.  Each expert row is independent,
    so the rank fills a buffer of its own pairs at their slots among its
    own, of which an expert takes at most S_loc, and runs the grouped FFN
    on it."""
    e, k = cfg.n_experts, cfg.top_k
    split = None if mesh is None else seq_split()
    s = x.shape[1]
    cap = moe_capacity(cfg, s * (1 if split is None else split[3]))
    probs, top_i, flat_e, slot, keep, w = _route(x, params["router"], cfg,
                                                 cap, split)
    aux = _aux(probs, top_i, e, mesh, _token_axes(mesh) if mesh else ())
    mp = tp_split("moe.w_in", (e, cfg.d_model, cfg.d_ff), params["w_in"])
    if mp is not None:
        x, w = copy_to(x, mp, "model"), copy_to(w, mp, "model")
    buf, b_idx = _dispatch(x, flat_e, slot, keep, e,
                           cap if split is None else min(cap, s), k)
    y = _combine(_experts(params, buf, cfg, x.shape[0] * s), b_idx, flat_e,
                 slot, w, k)
    return (y if mp is None else all_reduce(y, mp, "model")), aux


def _local_experts(params, cfg: ArchConfig, nm: int) -> int:
    e_loc = params["w_in"].shape[-3]
    if e_loc * nm != cfg.n_experts:
        raise ValueError(f"a rank of a mesh with {nm} ranks on \"model\" "
                         f"holds {cfg.n_experts // nm} of the "
                         f"{cfg.n_experts} experts (launch/shardings."
                         f"shard_params); got {e_loc}")
    return e_loc


def _moe_expert_parallel(params, x, cfg: ArchConfig, mesh):
    """The reference's ``_moe_expert_parallel`` (``repro/models/mlp.py:
    177``): every rank of "model" routes the whole block (B_loc,S,D) alike,
    scatters the pairs bound for its own experts into (B_loc, E/nm, C, D)
    at the same capacity and slots as the dense dispatch, runs its experts
    and combines their outputs; an all-reduce over "model" sums the ranks'
    shares.  The tokens and combine weights enter the rank-local work
    through ``copy_to``, so their gradients add every rank's share.  With
    the rows split over "model" (an "fsdp" training step), see
    ``_moe_rows_gathered``."""
    if "model" in ambient_rows():
        return _moe_rows_gathered(params, x, cfg, mesh)
    e, k = cfg.n_experts, cfg.top_k
    e_loc = _local_experts(params, cfg, MeshSpec.of(mesh).shape["model"])
    e0 = coordinate(mesh)["model"] * e_loc
    cap = moe_capacity(cfg, x.shape[1])
    probs, top_i, flat_e, slot, keep, w = _route(x, params["router"], cfg,
                                                 cap)
    aux = _aux(probs, top_i, e, mesh, batch_axes(mesh))
    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    le = torch.where(local, flat_e - e0, 0)
    gate = keep & local
    buf, b_idx = _dispatch(copy_to(x, mesh, "model"), le, slot, gate, e_loc,
                           cap, k)
    y = _combine(_experts(params, buf, cfg, x.shape[0] * x.shape[1]), b_idx,
                 le, slot,
                 copy_to(w, mesh, "model") * gate, k)
    return all_reduce(y, mesh, "model"), aux


def _moe_rows_gathered(params, x, cfg: ArchConfig, mesh):
    """The all-reduce path with the rows split over "model" (an "fsdp"
    training step whose sequence "model" does not divide): each rank
    routes its own rows (B_loc,S,D) at the dense dispatch's capacity and
    slots, gathers the rows, their routing and combine weights over
    "model" (the gather's backward sums the ranks' shares of their
    gradients), runs its experts on the pairs bound for them, and the
    ranks' shares of y are summed and cut back into each rank's rows
    (``scatter_sum``, the gather's transpose).  Each rank routes other
    rows, so the router's gradient is the rank's share, which the router's
    own gather sums."""
    e, k = cfg.n_experts, cfg.top_k
    e_loc = _local_experts(params, cfg, MeshSpec.of(mesh).shape["model"])
    e0 = coordinate(mesh)["model"] * e_loc
    cap = moe_capacity(cfg, x.shape[1])
    probs, top_i, flat_e, slot, keep, w = _route(x, params["router"], cfg,
                                                 cap)
    aux = _aux(probs, top_i, e, mesh, ambient_rows())
    flat_e, slot, keep = gather_leaf(
        torch.stack([flat_e, slot, keep.long()]), mesh, 1)
    keep = keep.bool()
    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    le = torch.where(local, flat_e - e0, 0)
    gate = keep & local
    xs = gather_leaf(x, mesh, 0)
    buf, b_idx = _dispatch(xs, le, slot, gate, e_loc, cap, k)
    y = _combine(_experts(params, buf, cfg, xs.shape[0] * xs.shape[1]),
                 b_idx, le, slot,
                 gather_leaf(w, mesh, 0) * gate, k)
    return scatter_sum(y, mesh, 0), aux


def _moe_expert_parallel_a2a(params, x, cfg: ArchConfig, mesh):
    """The reference's ``_moe_expert_parallel_a2a`` (``repro/models/mlp.py:
    82``): every rank of "model" routes its slice of the sequence
    (B_loc, S/nm, D) into (B_loc, E, C, D) at the slice's capacity; an
    all-to-all sends each rank the slots of its experts, (B_loc, E/nm,
    nm*C, D), in rank order; its experts run; a second all-to-all returns
    the outputs, each rank combines its slice, and the slices are gathered
    into (B_loc, S, D).  The router enters through ``copy_to``: each rank
    routes other tokens of the same rows, so its gradient adds the ranks'
    shares.

    With the rows split over "model" (an "fsdp" training step) the block
    comes in as the rank's rows (B/n, S, D): an all-to-all over "model"
    gives each rank its data group's rows at its slice of the sequence
    (B/nb, S/nm, D), and the reverse one gives the rank its rows back; the
    router, gathered whole by the layer, enters as it is (its gather's
    reduce-scatter sums the ranks' shares).  Under a sequence split see
    ``_moe_a2a_seq``."""
    split = seq_split()
    if split is not None:
        return _moe_a2a_seq(params, x, cfg, mesh, split)
    e, k = cfg.n_experts, cfg.top_k
    nm = MeshSpec.of(mesh).shape["model"]
    _local_experts(params, cfg, nm)
    cap = moe_capacity(cfg, x.shape[1] // nm)
    rows = "model" in ambient_rows()
    if rows:
        def part():
            return all_to_all(x, mesh, "model", split_dim=1, concat_dim=0)
        router, n_summed = params["router"], 1
    else:
        def part():
            return seq_slice(x, mesh, "model", 1)
        router, n_summed = copy_to(params["router"], mesh, "model"), nm
    # x's part is taken once for the routing and once for the dispatch, as
    # the dense dispatch reads x twice: x's gradient then adds the same
    # terms in the same order, and one rank gives the dense dispatch's bits
    probs, top_i, flat_e, slot, keep, w = _route(part(), router, cfg, cap)
    aux = _aux(probs, top_i, e, mesh, (*batch_axes(mesh), "model"),
               n_summed)
    buf, b_idx = _dispatch(part(), flat_e, slot, keep, e, cap, k)
    recv = all_to_all(buf, mesh, "model", split_dim=1, concat_dim=2)
    # the experts take the pairs of every rank's slice of the block
    back = all_to_all(_experts(params, recv, cfg, nm * flat_e.numel() // k),
                      mesh, "model", split_dim=2, concat_dim=1)
    y = _combine(back, b_idx, flat_e, slot, w, k)
    if rows:
        return all_to_all(y, mesh, "model", split_dim=0, concat_dim=1), aux
    return seq_gather(y, mesh, "model", 1), aux


def _moe_a2a_seq(params, x, cfg: ArchConfig, mesh, split):
    """The all-to-all path over a split sequence: x (B_loc, s, D) is the
    rank's slice of its rows (``common.seq_split``), "model" among the
    sequence's axes.  The reference routes the block ``P(bspec, "model")``
    (``repro/models/mlp.py:104-109``): its rows over the data axes where
    the rows divide them, and model slice m of the sequence, S/nm tokens,
    at the slice's capacity ``moe_capacity(cfg, S // nm)``, slots counted
    within the slice.

    Where the sequence lies over "model" alone (the rows over every data
    axis), that block is the rank's part, routed as it comes and returned
    as the rank's slice of y.  Otherwise (the rows over a prefix of the
    data axes, the sequence over the rest and "model": a one-row batch on
    (pod, data, model)) the block is every row of model slice m, which
    other ranks' parts make up: the rank gathers x over the rows' and the
    sequence's axes and cuts the slice out, every rank of the same "model"
    coordinate routing the same block, then gathers the blocks' y over
    "model" and cuts out its own part.  A first design: a leaner exchange
    would send each block only its tokens (ROADMAP.md item 10).

    The router enters as it is and aux is a mean over every rank: each
    rank's loss reads its own tokens' y, so its gradient is its share,
    which the router's gather sums (``_aux``'s ``n_summed`` 1).  Every
    gather's backward reduce-scatters, so the blocks' gradients reach the
    ranks whose tokens they are."""
    _, seq, index, count = split
    e, k = cfg.n_experts, cfg.top_k
    nm = MeshSpec.of(mesh).shape["model"]
    _local_experts(params, cfg, nm)
    rows = ambient_rows()
    block = tuple(seq) == ("model",)
    if block:
        def part():
            return x
    else:
        whole = gather_leaf(x, mesh, 0, rows) if rows else x
        whole = gather_leaf(whole, mesh, 1, seq)
        s = whole.shape[1] // nm
        m = coordinate(mesh)["model"]

        def part():
            return whole.narrow(1, m * s, s)
    # taken twice, as ``_moe_expert_parallel_a2a`` takes it
    cap = moe_capacity(cfg, part().shape[1])
    probs, top_i, flat_e, slot, keep, w = _route(part(), params["router"],
                                                 cfg, cap)
    aux = _aux(probs, top_i, e, mesh, MeshSpec.of(mesh).axis_names)
    buf, b_idx = _dispatch(part(), flat_e, slot, keep, e, cap, k)
    recv = all_to_all(buf, mesh, "model", split_dim=1, concat_dim=2)
    back = all_to_all(_experts(params, recv, cfg, nm * flat_e.numel() // k),
                      mesh, "model", split_dim=2, concat_dim=1)
    y = _combine(back, b_idx, flat_e, slot, w, k)
    if block:
        return y, aux
    y = gather_leaf(y, mesh, 1, "model")
    if rows:
        r, nr = seq_rank(mesh, rows)
        y = y.narrow(0, r * x.shape[0], x.shape[0])
    return y.narrow(1, index * x.shape[1], x.shape[1]), aux
