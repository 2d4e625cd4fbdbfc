"""Shared building blocks: device choice, norms, RoPE, init, the loss, and
the ambient mesh and sharding mode."""
from __future__ import annotations

import contextlib
import functools

import torch

from ..launch.collectives import all_reduce, copy_to, gather_leaf, seq_gather
from ..launch.mesh import MeshSpec, batch_axes, coordinate
from ..launch.shardings import (cache_shardings, fsdp_gathers, model_dim,
                                param_spec)
from ..roofline import counting


def require_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller names another.

    Raises when CUDA is asked for and absent, instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return device


def same_device(a, b) -> bool:
    """``a`` and ``b`` name one device ("cuda" names the current card)."""
    def resolved(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return resolved(a) == resolved(b)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale`` (the scales init to zero)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rms_norm_cols(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                  mesh=None) -> torch.Tensor:
    """``rms_norm`` of rows of which ``x`` holds this rank's columns over
    the "model" ranks of ``mesh`` (None: the whole rows), ``scale`` the
    same columns of the scales: the f32 sum of squares of the rank's
    columns, summed over "model" and divided by the whole row's width,
    is the statistic of every rank's columns.  The sum goes through "g"
    and then "f" (``all_reduce``, ``copy_to``): each rank uses it on its
    own columns, so the gradient of each rank's share is the sum of every
    rank's.  Without a mesh the same f32 sum over the row, divided by its
    width."""
    dt = x.dtype
    x = x.float()
    ss = x.square().sum(dim=-1, keepdim=True)
    width = x.shape[-1]
    if mesh is not None:
        ss = copy_to(all_reduce(ss, mesh, "model"), mesh, "model")
        width *= MeshSpec.of(mesh).shape["model"]
    x = x * torch.rsqrt(ss / width + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotates the two split halves of hd (not interleaved pairs) with f32
    angles and casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (...,S,hd/2)
    angles = angles[..., None, :]                            # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_DRAW_CHUNK = 1 << 26     # values drawn in f32 at once, at least one slice


def normal_init(generator: torch.Generator | None, shape, std: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std^2), drawn in f32 and cast into a preallocated leaf of
    ``dtype``, slice by slice of the leading axis: each draw covers whole
    slices, one or as many as fit 2^26 values.  The f32 buffer is that
    chunk, not the leaf: a stacked (L, E, D, F) expert leaf never needs an
    f32 copy of all L layers.

    ``device="meta"`` (with no generator) gives the leaf's shape and dtype
    without memory."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta or out.numel() == 0:
        return out
    rows = max(1, _DRAW_CHUNK // out[0].numel())
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32,
                               device=out.device).mul_(std))
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0,
                       count: int | None = None) -> torch.Tensor:
    """Mean CE over all positions; logits (B,S,V), labels (B,S) int.  f32
    logits, logsumexp minus the gold logit, plus ``z_loss * lse^2``.  With
    ``count`` the sum over the positions divided by it (0 where there are
    none, still in the autograd graph)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean() if count is None else loss.sum() / count


# "tp" (the default): every leaf that the rules split over "model" is held
# and computed on as the rank's slice (tensor parallelism, ``tp_split``),
# and the expert-parallel MoE combines by an all-reduce over "model".
# "fsdp": every leaf is held as the rank's slice over the whole mesh
# (``launch/shardings.fsdp_spec``) and gathered whole at each use, a layer's
# leaves inside its remat unit (``gather_layer``), with no tensor
# parallelism inside the model, as the reference's fsdp mode ignores
# "model" there (``repro/models/common.py:62-65``); the experts stay split
# over "model" and the MoE dispatches by all-to-all when "model" divides
# the sequence (``models/mlp.py``).  ``SHARDING_MODE`` is the mode a Model is
# built in (``Model.mode``); its methods install that mode with its mesh
# (``use_mesh``), and the models read the installed one, so a later
# ``set_sharding_mode`` changes no model already built.
SHARDING_MODE = ["tp"]
# the mesh, mode, row axes, sequence axes, whole batch leaves and the decode
# cache's split positions of ``use_mesh``: plain globals, not context
# variables, because the autograd engine runs a CUDA backward (and remat's
# recompute inside it) on threads of its own
_AMBIENT = [(None, None, (), (), (), ())]


def set_sharding_mode(mode: str) -> None:
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding mode {mode!r}: want tp or fsdp")
    SHARDING_MODE[0] = mode


@contextlib.contextmanager
def use_mesh(mesh, mode: str | None = None, rows: tuple | None = None,
             seq: tuple = (), whole: tuple = (), cache: tuple = ()):
    """Run the model on ``mesh`` (a DeviceMesh, or None for one process) in
    sharding ``mode`` (default: ``SHARDING_MODE``'s), the counterpart of
    the reference's ``with mesh:``.  ``rows`` names the axes over which the
    batch's rows are split (``launch/shardings.split_batch``, or
    ``row_axes`` of a training batch); by default the data axes, the rows
    alike on every rank of "model" (serving).  ``seq`` names the axes over
    which each row's sequence is split (``split_batch`` of an "fsdp" batch
    smaller than the mesh), each rank holding one contiguous slice
    (``seq_rank``); by default none.  ``whole`` names the batch's leaves
    that lie whole on every rank beside a split sequence (``split_batch``:
    whisper's frames where the axes do not divide them; ``batch_split``).
    ``cache`` names the decode cache's leaves whose positions lie over
    axes, ((leaf, axes), ...) (``launch/steps.make_serve_step`` of a batch
    the batch axes do not divide: context-parallel decode, ``cache_split``);
    by default none.  A training step's backward belongs inside too: remat
    recomputes the forward there."""
    prev = _AMBIENT[0]
    if rows is None:
        rows = () if mesh is None else batch_axes(mesh)
    seq = tuple(seq) if mesh is not None else ()
    _AMBIENT[0] = (mesh, SHARDING_MODE[0] if mode is None else mode,
                   tuple(rows), seq, tuple(whole) if seq else (),
                   tuple(cache) if mesh is not None else ())
    try:
        yield mesh
    finally:
        _AMBIENT[0] = prev


@contextlib.contextmanager
def whole_sequence():
    """Within it no sequence is split (``seq_split`` is None); the mesh,
    the mode and the rows stay: a model part that runs a leaf which lies
    whole beside a split sequence (whisper's encoder on its rows' whole
    frames).  Enter it inside a remat unit, so that the recompute runs
    under it too."""
    prev = _AMBIENT[0]
    _AMBIENT[0] = (*prev[:3], (), (), prev[5])
    try:
        yield
    finally:
        _AMBIENT[0] = prev


def ambient_mesh():
    """The mesh ``use_mesh`` installed, or None."""
    return _AMBIENT[0][0]


def ambient_mode():
    """The sharding mode ``use_mesh`` installed with its mesh."""
    return _AMBIENT[0][1]


def ambient_rows() -> tuple:
    """The axes over which ``use_mesh`` says the rows are split."""
    return _AMBIENT[0][2]


def ambient_seq() -> tuple:
    """The axes over which ``use_mesh`` says the sequence is split."""
    return _AMBIENT[0][3]


def ambient_whole() -> tuple:
    """The batch leaves that ``use_mesh`` says lie whole on every rank
    beside the split sequence."""
    return _AMBIENT[0][4]


def ambient_cache() -> tuple:
    """The decode cache's leaves whose positions ``use_mesh`` says lie over
    axes: ((leaf, axes), ...)."""
    return _AMBIENT[0][5]


def seq_rank(mesh, axes, coord: dict[str, int] | None = None
             ) -> tuple[int, int]:
    """(index, count): which of ``count`` contiguous slices of a sequence
    split over ``axes`` the rank at ``coord`` ({axis: index}; this
    process's on a DeviceMesh by default) holds, the first axis the major
    one, as ``launch/shardings.local_slice`` cuts a dim and
    ``collectives.gather_leaf`` joins it."""
    spec = MeshSpec.of(mesh)
    coord = coordinate(mesh) if coord is None else coord
    index, count = 0, 1
    for a in axes:
        index, count = index * spec.shape[a] + coord[a], count * spec.shape[a]
    return index, count


def seq_split():
    """(mesh, axes, index, count) of the sequence split that ``use_mesh``
    installed (``seq_rank``), or None where each rank holds whole rows."""
    mesh, seq = _AMBIENT[0][0], _AMBIENT[0][3]
    if mesh is None or not seq:
        return None
    return (mesh, seq, *seq_rank(mesh, seq))


def cache_split(key: str):
    """(mesh, axes, index, count) where the positions of the decode cache's
    leaf ``key`` lie over ``axes`` (``use_mesh``'s ``cache``): the rank at
    ``index`` of ``count`` (``seq_rank``) holds positions [index t,
    (index + 1) t) of its leaf's t; None where the rank holds every
    position."""
    mesh, cache = _AMBIENT[0][0], dict(_AMBIENT[0][5])
    if mesh is None or key not in cache:
        return None
    return (mesh, cache[key], *seq_rank(mesh, cache[key]))


def batch_split(key: str):
    """``seq_split`` where the batch's leaf ``key`` is split as the tokens
    are; None where no sequence is split or where that leaf lies whole on
    every rank beside them (``use_mesh``'s ``whole``)."""
    return None if key in _AMBIENT[0][4] else seq_split()


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``x``, a batch leaf that lies whole on every rank
    beside a split sequence: the part of its dim 0 that the rows' axes
    give the rank (``seq_rank`` of ``ambient_rows``, as ``local_slice``
    cuts the tokens)."""
    mesh, _, rows = _AMBIENT[0][:3]
    if mesh is None or not rows:
        return x
    index, count = seq_rank(mesh, rows)
    size = x.shape[0] // count
    return x.narrow(0, index * size, size)


@functools.lru_cache(maxsize=None)
def _split_dim(name: str, whole: tuple, mesh: MeshSpec) -> int | None:
    return model_dim(param_spec(name, whole, mesh))


def tp_split(name: str, whole: tuple, leaf: torch.Tensor | None = None):
    """The ambient mesh where its mode is "tp" and the rules split a leaf
    ``name`` of shape ``whole`` over "model" (``launch/shardings.
    param_spec``, by which ``shard_params`` sliced it), else None.  Given
    ``leaf``, the rank's part, raises naming the shapes unless it holds the
    rank's share of the split dim.  At one rank of "model" every dim the
    rules would split counts as split, so that a (1, 1) mesh runs the
    tensor-parallel path and its collectives."""
    mesh, mode = _AMBIENT[0][:2]
    if mesh is None or mode != "tp":
        return None
    spec = MeshSpec.of(mesh)
    d = _split_dim(name, tuple(whole), spec)
    if d is None:
        return None
    part = whole[d] // spec.shape["model"]
    if leaf is not None and leaf.shape[d - len(whole)] != part:
        raise ValueError(f"{name}: a rank of \"model\" holds {part} of "
                         f"{whole[d]} in dim {d} of {tuple(whole)} "
                         f"(launch/shardings.shard_params in \"tp\" mode); "
                         f"the leaf is {tuple(leaf.shape)}")
    return mesh


def tp_whole(name: str, whole: tuple, leaf: torch.Tensor) -> torch.Tensor:
    """The whole leaf of which ``leaf`` is the rank's part: gathered over
    "model" where ``tp_split`` holds it in slices.  Every rank of "model"
    uses it on the same rows, so the gradient of the whole leaf is alike on
    each and the rank keeps its own slice of it (``seq_gather``)."""
    mesh = tp_split(name, whole, leaf)
    if mesh is None:
        return leaf
    return seq_gather(leaf, mesh, "model", _split_dim(name, tuple(whole),
                                                      MeshSpec.of(mesh))
                      - len(whole))


@functools.lru_cache(maxsize=None)
def _kv_dim(cfg, mesh: MeshSpec) -> int | None:
    whole = (1, 1, 1, cfg.n_kv_heads, cfg.head_dim)
    return model_dim(cache_shardings({"k": whole}, cfg, mesh)["k"])


def kv_split(cfg):
    """(mesh, index, count) where the decode cache's kv heads lie over the
    ambient mesh's "model" ranks (``launch/shardings.cache_shardings``, in
    both modes: where "model" divides the kv heads, at one rank of it too,
    as ``tp_split`` counts a split): the rank at ``index`` of ``count``
    (``seq_rank``) holds kv heads [index K/count, (index + 1) K/count);
    else None."""
    mesh = _AMBIENT[0][0]
    if mesh is None or _kv_dim(cfg, MeshSpec.of(mesh)) is None:
        return None
    return (mesh, *seq_rank(mesh, ("model",)))


def state_whole(cfg) -> dict:
    """{"conv": (dim, size), "ssm": (dim, size)}: the dim of each mamba
    decode state that ``cache_shardings`` may lay over "model" (the conv's
    di + 2N channels, the ssm state's H heads) and its whole size."""
    return {"conv": (-1, cfg.d_inner + 2 * cfg.ssm_state),
            "ssm": (-3, cfg.ssm_heads)}


@functools.lru_cache(maxsize=None)
def _state_dims(cfg, mesh: MeshSpec) -> dict:
    """{"conv": dim, "ssm": dim}: the dim of a mamba decode state that
    ``cache_shardings`` lays over "model" (the conv's channels, the ssm
    state's heads), None where it keeps it whole."""
    lead = (1, 1) if cfg.family == "hybrid" else (1,)
    c = cfg.d_inner + 2 * cfg.ssm_state
    specs = cache_shardings(
        {"conv": (*lead, 1, cfg.ssm_conv - 1, c),
         "ssm": (*lead, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)},
        cfg, mesh)
    return {k: model_dim(v) for k, v in specs.items()}


def state_split(cfg, key: str):
    """(mesh, index, count) where the decode cache's mamba state ``key``
    ("conv": its di + 2N channels, "ssm": its H heads) lies over the
    ambient mesh's "model" ranks (``launch/shardings.cache_shardings``, in
    both modes; at one rank of "model" too, as ``kv_split`` counts): the
    rank at ``index`` of ``count`` holds the contiguous part [index n /
    count, (index + 1) n / count); else None."""
    mesh = _AMBIENT[0][0]
    if mesh is None or _state_dims(cfg, MeshSpec.of(mesh))[key] is None:
        return None
    return (mesh, *seq_rank(mesh, ("model",)))


def mamba_split(cfg):
    """(mesh, index, count) where both mamba decode states lie over the
    ambient mesh's "model" ranks (``state_split``: H and di + 2N divide
    them), else None.  There the rank at ``index`` of ``count`` runs the
    mamba block on its heads [index H / count, (index + 1) H / count) in
    "tp" mode (whose rules then split ``in_proj``, ``conv_w``, ``conv_b``
    and ``out_proj`` over "model" too), and a decode step on them in both
    modes (``models/ssm.py``)."""
    split = state_split(cfg, "conv")
    return split if split is not None and state_split(cfg, "ssm") else None


_gathers = functools.lru_cache(maxsize=None)(fsdp_gathers)


def fsdp_mesh():
    """The ambient mesh where its mode is "fsdp", else None."""
    mesh, mode = _AMBIENT[0][:2]
    return mesh if mode == "fsdp" else None


def fsdp_whole(name: str, whole: tuple, leaf: torch.Tensor,
               lead: int = 0) -> torch.Tensor:
    """In "fsdp" mode, the whole of a leaf ``name`` (of whole shape
    ``whole``) of which ``leaf`` is the rank's part: gathered as
    ``launch/shardings.fsdp_gathers`` says (``collectives.gather_leaf``;
    its backward reduce-scatters the gradient), else ``leaf``.  ``leaf`` is
    one layer of a stacked leaf when ``lead`` > 0, its ``lead`` stacked
    dims indexed away; a split on a stacked dim was gathered before
    (``gather_layers``)."""
    mesh = fsdp_mesh()
    if mesh is None:
        return leaf
    for d, axes in _gathers(name, tuple(whole), MeshSpec.of(mesh)):
        if d >= lead:
            leaf = gather_leaf(leaf, mesh, d - lead, axes)
    return leaf


def _walk(tree: dict, prefix: str, fn) -> dict:
    return {k: _walk(v, f"{prefix}{k}.", fn) if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def gather_layer(tree: dict, prefix: str, shapes: dict,
                 lead: int = 1) -> dict:
    """The leaves of one layer's tree (``prefix`` the stacked tree's dotted
    name, ``shapes`` every leaf's whole stacked shape, ``lead`` the stacked
    dims indexed away) gathered whole in "fsdp" mode (``fsdp_whole``), the
    tree as it is otherwise.  Called inside the layer's remat unit, so that
    remat's recompute gathers again and no layer's whole weights outlive
    it: ZeRO-3 as XLA does it in the reference's scan."""
    if fsdp_mesh() is None:
        return tree
    return _walk(tree, f"{prefix}.",
                 lambda n, v: fsdp_whole(n, shapes[n], v, lead))


def gathering(fn, shapes: dict, prefix: str, lead: int = 1):
    """``fn(lp, *args)`` with the layer's leaves ``lp`` (of the stacked tree
    ``prefix``) first gathered whole in "fsdp" mode (``gather_layer``):
    wrapped by remat (``lm._maybe_ckpt``), the gathers run inside the remat
    unit, and again in its recompute."""
    def run(lp, *args):
        return fn(gather_layer(lp, prefix, shapes, lead), *args)

    return run


def gather_layers(tree: dict, prefix: str, shapes: dict,
                  lead: int = 1) -> dict:
    """A stacked tree with each leaf that "fsdp" mode splits on one of its
    ``lead`` stacked dims (mamba2-780m's (48, 48) ``A_log``, whose layers
    the largest-dim rule splits) gathered whole over those dims, once a
    forward, before the layers are unbound."""
    mesh = fsdp_mesh()
    if mesh is None:
        return tree

    def one(name, leaf):
        for d, axes in _gathers(name, tuple(shapes[name]), MeshSpec.of(mesh)):
            if d < lead:
                leaf = gather_leaf(leaf, mesh, d, axes)
        return leaf

    return _walk(tree, f"{prefix}.", one)


@functools.lru_cache(maxsize=None)
def whole_shapes(init, cfg) -> dict:
    """{dotted name: whole shape} of the tree that ``init(cfg, None,
    "meta")`` describes (a family module's ``init_params``), built outside
    a counter's booking."""
    out: dict = {}
    with counting.unbooked():
        tree = init(cfg, None, "meta")
    _walk(tree, "", lambda n, v: out.__setitem__(n, tuple(v.shape)))
    return out
