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
``out_proj`` over "model" (their last dim, ``out_proj``'s first); each rank
holds its slices and gathers the whole leaves on use (``common.tp_whole``), so
the block, the SSD kernels and the decode states run whole on every rank.
Splitting the computation is left for later: the packed [z, xBC, dt]
columns of ``in_proj`` do not fall on the ranks' boundaries.  In "fsdp"
mode the layer's leaves arrive gathered whole (``common.gather_layer``;
``A_log``, ``D`` and ``dt_bias``, whose layers the rule may split, once a
forward by ``common.gather_layers``).

Where a batch smaller than the mesh splits the sequence (``common.
seq_split``: rank r of n holds one contiguous slice), the conv reads the
previous slice's last ``ssm_conv - 1`` inputs (``collectives.seq_halo``)
and the scan takes the state across the ranks by its linearity in its
initial state: each rank runs ``ssd_chunked`` on its slice from a zero
state, launching the SSD kernel at its own chunks, and returns its final
state h_r and its total decay a_r = exp(sum dt A); both are gathered over
the sequence's axes, the state entering rank r is the fold h_in = sum_{j<r}
(prod_{j<i<r} a_i) h_j, and the rank adds (C_t . h_in) exp(cum_t), cum
taken from its own start, to y and a_r h_in to its final state.  A
prefill's cache is the last rank's, on every rank.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_intra_chunk
from ..launch.collectives import gather_leaf, seq_halo, seq_last
from ..roofline import counting
from .common import normal_init, rms_norm, seq_split, tp_whole
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


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


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


def mamba_forward(params, x, cfg: ArchConfig, return_state: bool = False):
    """Full-sequence Mamba2 block.  x (B,S,D) -> (y, (conv_state, ssm_state)
    or None); the states are in x's dtype."""
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    params = _whole(params, cfg)
    zxbcdt = torch.einsum("bsd,dk->bsk", x, params["in_proj"])
    z, xbc_raw, dt = _split_proj(zxbcdt, cfg)
    split = seq_split()
    halo = carry = None
    if split is not None:
        mesh, axes, r, nr = split
        halo = seq_halo(xbc_raw, mesh, axes, r, cfg.ssm_conv - 1)
        carry = _carry(mesh, axes, r, nr)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"], halo)
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    xh = xs.reshape(*xs.shape[:2], h, p)
    y, h_final = ssd_chunked(xh, dt, params["A_log"], bmat, cmat,
                             cfg.ssm_chunk, carry=carry)
    y = y + (params["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(*y.shape[:2], di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, params["out_proj"])
    if not return_state:
        return out, None
    if split is not None:    # the whole sequence's end: the last rank's
        return out, (seq_halo(xbc_raw, mesh, axes, nr, cfg.ssm_conv - 1),
                     seq_last(h_final, mesh, axes).to(x.dtype))
    return out, (xbc_raw_tail(x, params["in_proj"], cfg),
                 h_final.to(x.dtype))


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


def xbc_raw_tail(x, in_proj, cfg: ArchConfig):
    """The last (conv_k - 1) pre-activation conv inputs of x (B,S,D) through
    the whole ``in_proj``, for the decode cache.  A prompt shorter than that
    is left-padded with zeros, the rows ``_causal_conv`` itself sees before
    the first token.  (The reference returns fewer rows there, and its
    engine then serves 1- and 2-token prompts wrongly: ROADMAP.md, faults
    of the reference.)"""
    k1 = cfg.ssm_conv - 1
    zxbcdt = torch.einsum("bsd,dk->bsk", x[:, -k1:, :], in_proj)
    _, xbc, _ = _split_proj(zxbcdt, cfg)
    return F.pad(xbc, (0, 0, k1 - xbc.shape[1], 0))


def mamba_decode(params, x1, conv_state, ssm_state, cfg: ArchConfig):
    """Single-token step.

    x1 (B,1,D); conv_state (B,K-1,di+2N); ssm_state (B,H,N,P).  Returns
    (y (B,1,D), (conv_state', ssm_state')): the state update is f32, cast
    back to ``ssm_state``'s dtype."""
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    params = _whole(params, cfg)
    zxbcdt = torch.einsum("bsd,dk->bsk", x1, params["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    window = torch.cat([conv_state, xbc], dim=1)           # (B,K,di+2N)
    conv = torch.einsum("bkc,kc->bc", window, params["conv_w"])
    conv = F.silu(conv + params["conv_b"])[:, None, :]     # (B,1,.)
    xs = conv[..., :di]
    bmat = conv[..., di:di + n].float()                    # (B,1,N)
    cmat = conv[..., di + n:].float()
    dtv = F.softplus(dt.float() + params["dt_bias"])[:, 0, :]   # (B,H)
    da = torch.exp(dtv * -torch.exp(params["A_log"]))           # (B,H)
    xh = xs.reshape(-1, h, p).float()                      # (B,H,P)
    inc = torch.einsum("bh,bn,bhp->bhnp", dtv, bmat[:, 0], xh)
    hnew = ssm_state.float() * da[..., None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], hnew)
    y = y + params["D"][:, None] * xh
    y = y.reshape(-1, 1, di).to(x1.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, params["out_proj"])
    return out, (window[:, 1:, :], hnew.to(ssm_state.dtype))
