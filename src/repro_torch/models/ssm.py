"""Mamba2 (state-space duality) block: chunked SSD for prefill, O(1) state
update for decode.

The chunked algorithm (Dao & Gu 2024) splits the sequence into chunks of
length L: inside a chunk the SSD form is an attention-like quadratic product,
which ``kernels.ssd.ssd_intra_chunk`` computes (the hand-written CUDA kernel
for CUDA tensors, its plain version on the CPU); across chunks only the
(H, N, P) states flow, through a Python loop (the reference has no kernel for
that part either).

Oracle for tests: ``kernels.ssd.ssd_reference`` (the stepwise recurrence).

In "tp" mode the rules split ``in_proj``, ``conv_w``, ``conv_b`` and
``out_proj`` over "model" (their last dim, ``out_proj``'s first) into
contiguous slices, which do not fall on the boundaries of the packed [z |
x | B | C | dt] columns nor of the conv's [x | B | C] channels.  Where the
decode states lie over "model" too (``common.mamba_split``: H and di + 2N
divide its ranks, at one rank too), rank r of nm runs the block on its
own heads [r H/nm, (r+1) H/nm): x enters through "f"; one column exchange
each (``collectives.exchange_columns``, whose backward sums the gradient
of a column that several ranks read, B's and C's, into the rank that
holds it) hands it [z_r | x_r | B | C | dt_r] of ``in_proj`` and [x_r | B
| C] of ``conv_w`` and ``conv_b`` from the ranks' slices (``_exchanged``);
the SSD kernels run at its H/nm heads; the gated norm's statistic is the
ranks' f32 sums of squares summed over "model" (``common.
rms_norm_cols``); ``out_proj``'s rows, the rank's own slice, give its
share of y, which "g" sums.  ``A_log``, ``D``, ``dt_bias`` and ``norm``,
whole on every rank, enter through one "f" before the rank takes its
heads' entries (``_own_heads``).  A decode step moves activations, not
weights: the rank projects x through its stored columns, the row is
gathered, it convolves its stored channels with its part of the conv
state, the conv output is gathered and it updates its heads' part of the
ssm state.  A prefill's states are the rank's parts the same way: its
heads of the final state, and its channels of the last inputs, projected
through its stored columns and gathered (``xbc_raw_tail``).  Elsewhere the
block runs whole on every rank (``common.tp_whole`` gathers the split
leaves), and a state that the rules split all the same is gathered for a
decode step and cut back (``_states_whole``, ``_states_own``).  In "fsdp"
mode the layer's leaves arrive gathered whole (``common.gather_layer``;
``A_log``, ``D`` and ``dt_bias``, whose layers the rule may split, once a
forward by ``common.gather_layers``) and the block runs whole; a decode
step on the rank's parts of the states cuts the rank's slices from the
whole leaves as "tp" holds them (``_stored``) and runs the same step.

Where a batch smaller than the mesh splits the sequence (``common.
seq_split``: rank r of n holds one contiguous slice), the conv reads the
previous slice's last ``ssm_conv - 1`` inputs (``collectives.seq_halo``)
and the scan takes the state across the ranks by its linearity in its
initial state: each rank runs ``ssd_chunked`` on its slice from a zero
state, launching the SSD kernel at its own chunks, and returns its final
state h_r and its total decay a_r = exp(sum dt A); both are gathered over
the sequence's axes, the state entering rank r is the fold h_in = sum_{j<r}
(prod_{j<i<r} a_i) h_j, and the rank adds (C_t . h_in) exp(cum_t), cum
taken from its own start, to y and a_r h_in to its final state.  The
halo and the state pass run on the channels and heads the rank computes
(``_block``).  A prefill's cache is the last rank's, on every rank.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_intra_chunk
from ..launch.collectives import (all_reduce, copy_to, exchange_columns,
                                  gather_leaf, seq_halo, seq_last)
from ..roofline import counting
from .common import (ambient_mode, mamba_split, normal_init, rms_norm_cols,
                     seq_split, state_split, state_whole, tp_split,
                     tp_whole)
from .config import ArchConfig


def init_mamba_params(generator, cfg: ArchConfig, dtype, device,
                      lead: tuple = ()) -> dict:
    """``lead`` prepends dims, e.g. (n_layers,) for the stacked layout.
    ``A_log``, ``D`` and ``dt_bias`` are f32 whatever ``dtype`` is, and
    ``A_log = log(linspace(1, 16, H))`` is set, not drawn."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    c = di + 2 * n
    proj_out = 2 * di + 2 * n + h
    f32 = torch.float32
    a_log = torch.empty((*lead, h), dtype=f32, device=device)
    if not a_log.is_meta:
        a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, device=device)))
    return {
        "in_proj": normal_init(generator, (*lead, d, proj_out), d ** -0.5,
                               dtype, device),
        "conv_w": normal_init(generator, (*lead, cfg.ssm_conv, c), 0.3, dtype,
                              device),
        "conv_b": torch.zeros((*lead, c), dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones((*lead, h), dtype=f32, device=device),
        "dt_bias": torch.zeros((*lead, h), dtype=f32, device=device),
        "norm": torch.zeros((*lead, di), dtype=dtype, device=device),
        "out_proj": normal_init(generator, (*lead, di, d), di ** -0.5, dtype,
                                device),
    }


@functools.lru_cache(maxsize=None)
def _whole_shapes(cfg: ArchConfig) -> dict:
    """{leaf: whole shape} of one layer's parameters, built outside a
    counter's booking."""
    with counting.unbooked():
        leaves = init_mamba_params(None, cfg, torch.float32, "meta")
    return {k: tuple(v.shape) for k, v in leaves.items()}


def _whole(params, cfg: ArchConfig) -> dict:
    """The layer's leaves, those of the block that "tp" mode splits
    gathered whole (``common.tp_whole``)."""
    shapes = _whole_shapes(cfg)
    return {k: tp_whole(k, shapes[k], v) if k in shapes else v
            for k, v in params.items()}


def _split_proj(zxbcdt, di: int, n: int):
    """(z, xBC, dt) of projected rows packed [z | x | B | C | dt], z and x
    ``di`` wide: the block's d_inner, or a rank's di/nm of its heads."""
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


@functools.lru_cache(maxsize=None)
def _wanted(cfg: ArchConfig, nm: int) -> tuple:
    """(in_proj's, the conv's): for each of ``nm`` ranks, the (start, stop)
    ranges of ``in_proj``'s packed columns and of the conv's di + 2N
    channels that its heads read, [z_r | x_r | B | C | dt_r] and [x_r | B |
    C] (``collectives.exchange_columns``)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, hl, t = di // nm, h // nm, 2 * di + 2 * n
    proj = tuple(((r * dl, (r + 1) * dl), (di + r * dl, di + (r + 1) * dl),
                  (2 * di, t), (t + r * hl, t + (r + 1) * hl))
                 for r in range(nm))
    conv = tuple(((r * dl, (r + 1) * dl), (di, di + 2 * n))
                 for r in range(nm))
    return proj, conv


_RULED = ("in_proj", "conv_w", "conv_b", "out_proj")


def _stored(params, cfg: ArchConfig, split) -> dict:
    """The layer's leaves with ``in_proj``, ``conv_w``, ``conv_b`` and
    ``out_proj`` the rank's slices as "tp" mode's rules lay them
    (``shard_params``: contiguous parts of the packed columns, the
    channels, ``out_proj``'s rows): in "tp" mode the leaves themselves
    (their shapes checked, ``common.tp_split``), in "fsdp" mode cut from
    the layer's gathered whole leaves."""
    mesh, r, nm = split
    shapes = _whole_shapes(cfg)
    if ambient_mode() == "tp":
        for k in _RULED:
            tp_split(k, shapes[k], params[k])
        return params
    cut = {}
    for k in _RULED:
        d = 0 if k == "out_proj" else len(shapes[k]) - 1
        size = shapes[k][d] // nm
        cut[k] = params[k].narrow(d, r * size, size)
    return {**params, **cut}


def _own_heads(params, cfg: ArchConfig, split) -> dict:
    """``A_log``, ``D``, ``dt_bias`` and ``norm``, whole on every rank,
    joined in f32 through one "f" (``copy_to``: each rank's gradient of
    its entries summed into every rank's whole leaf) and cut to the
    entries of the rank's heads."""
    mesh, r, nm = split
    h, di = cfg.ssm_heads, cfg.d_inner
    hl, dl = h // nm, di // nm
    joined = copy_to(torch.cat([params["A_log"], params["D"],
                                params["dt_bias"], params["norm"].float()]),
                     mesh, "model")
    return {"A_log": joined[r * hl:(r + 1) * hl],
            "D": joined[h + r * hl:h + (r + 1) * hl],
            "dt_bias": joined[2 * h + r * hl:2 * h + (r + 1) * hl],
            "norm": joined[3 * h + r * dl:3 * h + (r + 1) * dl]}


def _exchanged(params, cfg: ArchConfig, split) -> dict:
    """The leaves of the rank's heads (``mamba_split``'s ``split``) from
    the rank's slices: ``in_proj``'s [z_r | x_r | B | C | dt_r] and
    ``conv_w``'s and ``conv_b``'s [x_r | B | C] by one column exchange
    each (the bias joined to the weight's rows), ``out_proj``'s rows as
    held, and ``_own_heads``."""
    mesh, r, nm = split
    k = cfg.ssm_conv
    proj, conv = _wanted(cfg, nm)
    lv = _stored(params, cfg, split)
    wb = exchange_columns(torch.cat([lv["conv_w"], lv["conv_b"][None]]),
                          mesh, "model", 1, conv)
    return {"in_proj": exchange_columns(lv["in_proj"], mesh, "model", 1,
                                        proj),
            "conv_w": wb[:k], "conv_b": wb[k], "out_proj": lv["out_proj"],
            **_own_heads(params, cfg, split)}


def _states_whole(conv, ssm, cfg: ArchConfig):
    """The decode states whole, for a block that runs whole: a part that
    ``cache_shardings`` lays over "model" (``common.state_split``) gathered
    over it."""
    out = []
    for key, t in (("conv", conv), ("ssm", ssm)):
        dim, n = state_whole(cfg)[key]
        split = state_split(cfg, key)
        if split is not None and t.shape[dim] != n:
            t = gather_leaf(t, split[0], dim % t.dim())
        out.append(t)
    return tuple(out)


def _states_own(conv, ssm, cfg: ArchConfig):
    """Whole decode states cut to the rank's parts where ``cache_shardings``
    lays them over "model" (``common.state_split``)."""
    out = []
    for key, t in (("conv", conv), ("ssm", ssm)):
        dim = state_whole(cfg)[key][0]
        split = state_split(cfg, key)
        if split is not None:
            size = t.shape[dim] // split[2]
            t = t.narrow(dim, split[1] * size, size)
        out.append(t)
    return tuple(out)


def _causal_conv(xbc, w, b, halo=None):
    """Depthwise causal conv along seq.  xbc (B,S,C), w (K,C); ``halo``
    (B,K-1,C) the inputs before the first row (zeros by default).  Written
    as the reference's K shifted multiply-adds (no cuDNN, so no TF32)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)) if halo is None else \
        torch.cat([halo.to(xbc.dtype), xbc], dim=1)
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(xh, dt, a_log, bmat, cmat, chunk: int, h_init=None,
                carry=None):
    """Chunked SSD.

    xh (B,S,H,P), dt (B,S,H) post-softplus, a_log (H,) with A = -exp(a_log),
    bmat/cmat (B,S,N).  Returns (y (B,S,H,P) in xh's dtype, h_final
    (B,H,N,P) f32).  ``carry(h, a)``, given, maps this scan's final state
    from ``h_init`` and its total decay exp(sum dt A) (B,H) to a state h_in
    entering before the first step, whose share the scan adds to y and to
    the final state: a split sequence's earlier slices (the module's
    docstring)."""
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    orig_s = s
    if s % l:
        # pad the tail: dt = 0 steps have decay exp(0) = 1 and zero
        # increment, so they change neither y[:orig_s] nor the final state
        pad = l - s % l
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        s += pad
    nc = s // l
    a = -torch.exp(a_log)                                  # (H,)
    dtf = dt.float()
    xc = xh.reshape(bsz, nc, l, h, p)
    dtc = dtf.reshape(bsz, nc, l, h)
    bc = bmat.reshape(bsz, nc, l, n).float()
    cc = cmat.reshape(bsz, nc, l, n).float()
    cum = torch.cumsum((dtf * a).reshape(bsz, nc, l, h), dim=2)

    y_intra, states = ssd_intra_chunk(xc, dtc, cum, bc, cc)

    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    hcur = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=xh.device)
            if h_init is None else h_init.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", cc, h_prevs) \
        * torch.exp(cum)[..., None]
    if carry is not None:
        tot = cum[:, :, -1, :]                             # (B,nc,H)
        decay = torch.exp(tot.sum(dim=1))                  # (B,H)
        h_in = carry(hcur, decay)
        run = cum + (torch.cumsum(tot, dim=1) - tot)[:, :, None, :]
        y_inter = y_inter + torch.einsum("bcin,bhnp->bcihp", cc, h_in) \
            * torch.exp(run)[..., None]
        hcur = hcur + decay[..., None, None] * h_in
    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :orig_s]
    return y.to(xh.dtype), hcur


def _block(p, x, cfg: ArchConfig, di: int, h: int, mesh=None):
    """The block on ``h`` heads of ``di`` inner columns whose leaves ``p``
    hold: the whole block, or (``mesh``) a rank's heads, whose norm takes
    its statistic over the ranks of "model".  Returns (the block's or the
    rank's share of y, the final state)."""
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xbc_raw, dt = _split_proj(zxbcdt, di, n)
    split = seq_split()
    halo = carry = None
    if split is not None:
        seq_mesh, axes, r, nr = split
        halo = seq_halo(xbc_raw, seq_mesh, axes, r, cfg.ssm_conv - 1)
        carry = _carry(seq_mesh, axes, r, nr)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"], halo)
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xs.reshape(*xs.shape[:2], h, hd)
    y, h_final = ssd_chunked(xh, dt, p["A_log"], bmat, cmat, cfg.ssm_chunk,
                             carry=carry)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(*y.shape[:2], di)
    y = rms_norm_cols(y * F.silu(z.float()).to(y.dtype), p["norm"],
                      cfg.norm_eps, mesh)
    return torch.einsum("bsk,kd->bsd", y, p["out_proj"]), h_final


def mamba_forward(params, x, cfg: ArchConfig, return_state: bool = False):
    """Full-sequence Mamba2 block.  x (B,S,D) -> (y, (conv_state, ssm_state)
    or None); the states are in x's dtype, in "tp" mode the rank's parts
    of them as ``cache_shardings`` lays them (``common.state_split``)."""
    di, h = cfg.d_inner, cfg.ssm_heads
    split = mamba_split(cfg) if ambient_mode() == "tp" else None
    if split is None:
        params = _whole(params, cfg)
        out, h_final = _block(params, x, cfg, di, h)
    else:
        mesh, _, nm = split
        out, h_final = _block(_exchanged(params, cfg, split),
                              copy_to(x, mesh, "model"), cfg, di // nm,
                              h // nm, mesh)
        out = all_reduce(out, mesh, "model")
    if not return_state:
        return out, None
    conv = xbc_raw_tail(x, params["in_proj"], cfg, split)
    if split is None and ambient_mode() == "tp":
        return out, _states_own(conv, h_final.to(x.dtype), cfg)
    seq = seq_split()
    if seq is not None:      # the whole sequence's end: the last rank's
        h_final = seq_last(h_final, seq[0], seq[1])
    return out, (conv, h_final.to(x.dtype))


def _carry(mesh, axes, index: int, count: int):
    """``ssd_chunked``'s ``carry`` for the rank at ``index`` of ``count``
    along a sequence split over ``axes``: every rank's final state and
    total decay gathered, and the fold of those before it, sum_{j<index}
    (prod_{j<i<index} a_i) h_j.  Every rank folds all ``count`` entries,
    those from ``index`` on masked to leave the sum as it is, so that every
    rank's backward meets the gathers' reduce-scatters."""
    def carry(h, a):
        hs = gather_leaf(h[None], mesh, 0, axes)           # (n,B,H,N,P)
        decays = gather_leaf(a[None], mesh, 0, axes)       # (n,B,H)
        before = torch.arange(count, device=h.device) < index
        hs = hs * before[:, None, None, None, None]
        decays = torch.where(before[:, None, None], decays, 1.0)
        h_in = torch.zeros_like(h)
        for j in range(count):
            h_in = h_in * decays[j][..., None, None] + hs[j]
        return h_in

    return carry


def xbc_raw_tail(x, in_proj, cfg: ArchConfig, split=None):
    """The last (conv_k - 1) pre-activation conv inputs of x (B,S,D) through
    ``in_proj``, for the decode cache; under a sequence split (``common.
    seq_split``) the whole sequence's, the last rank's on every rank.  A
    prompt shorter than that is left-padded with zeros, the rows
    ``_causal_conv`` itself sees before the first token.  (The reference
    returns fewer rows there, and its engine then serves 1- and 2-token
    prompts wrongly: ROADMAP.md, faults of the reference.)  With ``split``
    (``mamba_split``'s), ``in_proj`` is the rank's slice of its columns
    (``_stored``): the projected rows are gathered over "model" and the
    rank keeps its part of the channels, as the conv cache lies."""
    k1 = cfg.ssm_conv - 1
    zxbcdt = torch.einsum("bsd,dk->bsk", x[:, -k1:, :], in_proj)
    if split is not None:
        zxbcdt = gather_leaf(zxbcdt, split[0], 2)
    _, xbc, _ = _split_proj(zxbcdt, cfg.d_inner, cfg.ssm_state)
    if split is not None:
        size = xbc.shape[-1] // split[2]
        xbc = xbc[..., split[1] * size:(split[1] + 1) * size]
    seq = seq_split()
    if seq is not None:
        return seq_halo(xbc, seq[0], seq[1], seq[3], k1)
    return F.pad(xbc, (0, 0, k1 - xbc.shape[1], 0))


def _step(conv, ssm_state, z, dt, p, cfg: ArchConfig, di: int, h: int,
          mesh=None):
    """The state update and output of one token from the conv's output
    (B, di + 2N): ``h`` heads of ``di`` columns, as in ``_block``."""
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    conv = conv[:, None, :]                                # (B,1,.)
    xs = conv[..., :di]
    bmat = conv[..., di:di + n].float()                    # (B,1,N)
    cmat = conv[..., di + n:].float()
    dtv = F.softplus(dt.float() + p["dt_bias"])[:, 0, :]   # (B,H)
    da = torch.exp(dtv * -torch.exp(p["A_log"]))           # (B,H)
    xh = xs.reshape(-1, h, hd).float()                     # (B,H,P)
    inc = (dtv[..., None] * xh)[:, :, None, :] * bmat[:, 0, None, :, None]
    hnew = ssm_state.float() * da[..., None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], hnew)
    y = y + p["D"][:, None] * xh
    y = y.reshape(-1, 1, di).to(z.dtype)
    y = rms_norm_cols(y * F.silu(z.float()).to(y.dtype), p["norm"],
                      cfg.norm_eps, mesh)
    return torch.einsum("bsk,kd->bsd", y, p["out_proj"]), \
        hnew.to(ssm_state.dtype)


def mamba_decode(params, x1, conv_state, ssm_state, cfg: ArchConfig):
    """Single-token step.

    x1 (B,1,D); conv_state (B,K-1,di+2N); ssm_state (B,H,N,P), each the
    rank's part where ``cache_shardings`` lays it over "model"
    (``common.state_split``).  Returns (y (B,1,D), (conv_state',
    ssm_state')): the state update is f32, cast back to ``ssm_state``'s
    dtype.  Where both parts are the rank's (``common.mamba_split``) the
    rank works on its own heads, in both modes: it projects x1 through
    its slice of ``in_proj`` as "tp" lays it (``_stored``), the row is
    gathered over "model", it convolves its channels with its part of the
    conv state, the conv output is gathered, and it updates its heads'
    part of the ssm state; the ranks' shares of y are summed.  A cache of
    every channel or head there (an "fsdp" prefill's) raises."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    split = mamba_split(cfg)
    if split is None:
        conv_state, ssm_state = _states_whole(conv_state, ssm_state, cfg)
        p = _whole(params, cfg)
        zxbcdt = torch.einsum("bsd,dk->bsk", x1, p["in_proj"])
        z, xbc, dt = _split_proj(zxbcdt, di, n)
        window = torch.cat([conv_state, xbc], dim=1)       # (B,K,di+2N)
        conv = torch.einsum("bkc,kc->bc", window, p["conv_w"])
        conv = F.silu(conv + p["conv_b"])
        y, hnew = _step(conv, ssm_state, z, dt, p, cfg, di, h)
        return y, _states_own(window[:, 1:, :], hnew, cfg)
    mesh, r, nm = split
    dl, hl, cl = di // nm, h // nm, (di + 2 * n) // nm
    if conv_state.shape[-1] != cl or ssm_state.shape[-3] != hl:
        raise ValueError(
            f"decode states of {conv_state.shape[-1]} channels and "
            f"{ssm_state.shape[-3]} heads: want the rank's {cl} of "
            f"{di + 2 * n} and {hl} of {h} (Model.cache_part, "
            f"Model.own_heads)")
    lv = _stored(params, cfg, split)
    x1 = copy_to(x1, mesh, "model")
    row = gather_leaf(torch.einsum("bsd,dk->bsk", x1, lv["in_proj"]), mesh, 2)
    z, xbc, dt = _split_proj(row, di, n)
    window = torch.cat([conv_state, xbc[..., r * cl:(r + 1) * cl]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, lv["conv_w"])
    conv = gather_leaf(F.silu(conv + lv["conv_b"]), mesh, 1)    # (B,di+2N)
    conv = torch.cat([conv[:, r * dl:(r + 1) * dl], conv[:, di:]], dim=1)
    p = {**_own_heads(params, cfg, split), "out_proj": lv["out_proj"]}
    y, hnew = _step(conv, ssm_state, z[..., r * dl:(r + 1) * dl],
                    dt[..., r * hl:(r + 1) * hl], p, cfg, dl, hl, mesh)
    return all_reduce(y, mesh, "model"), (window[:, 1:, :], hnew)
