"""Step functions run by the trainer, the serving engine and the dry run
(``launch/dryrun.py``)."""
from __future__ import annotations

import math

import torch.distributed as dist

from .. import telemetry
from ..models import Model
from ..models.common import state_whole
from ..models.lm import kv_heads, state_parts
from ..optim import AdamW
from ..roofline import counting
from .mesh import MeshSpec, batch_axes
from .shardings import row_axes, spec_axes, split_batch


def make_train_step(model: Model, opt: AdamW):
    """One optimizer step on one batch, as the reference's
    ``make_train_step`` (``repro/launch/steps.py:11-25``).  ``state`` is
    {"params": {name: parameter}, "opt": the optimizer's state}; both are
    updated in place and returned with the metrics "loss", the loss's own
    ("ce", and "aux" for every family but the encoder-decoder), "lr" and
    "grad_norm" (0-d tensors).  ``batch`` is what ``Model.train_loss``
    takes: tokens and labels, and frames (whisper) or patches (llava).

    On a mesh (``model.mesh``) ``batch`` is the whole batch, as the
    reference's step takes it; the step keeps the rank's part
    (``launch/shardings.split_batch`` in the model's mode: its rows, and
    in "fsdp" mode its slice of their sequence where the batch is smaller
    than the mesh) and runs the forward and backward under
    ``model.on_mesh(split=...)`` of the axes that part lies over.  Each
    rank's loss is its share of the batch's: the mean over its labels,
    which every rank holds as many of, or for the VLM under a sequence
    split, whose ranks hold other numbers of text positions, their sum
    over the rank's own count of labels (``lm.train_loss``); so the mean of
    the ranks' losses is the batch's.  In "tp" mode
    every gradient and the loss's metrics are then averaged over the batch
    axes when they hold more than one rank (data parallelism); tensor and
    expert parallelism leave each rank of "model" the gradient of its
    slices and the whole gradient of every replicated leaf ("f" and "g",
    ``launch/collectives.py``), so nothing is summed over it.  In "fsdp"
    mode the gathers' backward has summed each sliced leaf's gradient over
    the axes its spec names (each rank's rows' share; the experts' split
    over "model" is expert parallelism, whose ranks hold other experts);
    every gradient is summed over the axes its spec does not name (over
    every axis for a leaf left whole, over "model" for experts fewer than
    it), the metrics over every axis, and all of them divided by the
    mesh's size, so the gradient is one process's.  AdamW's clip sums the
    sliced leaves' norms over the axes their specs name.

    Spans (``telemetry``): ``train.step`` (the allocator's ``mallocs``)
    holds ``train.forward`` and ``train.backward`` (remat's recompute
    included), ``train.reduce`` on a mesh of more than one rank of rows,
    and ``train.optimizer`` around the optimizer's ``update`` call; the
    forward, backward and optimizer with their stream time.  The
    optimizer's span is opened by its caller, not inside ``AdamW``, so
    that a profiler range a caller wraps ``update`` in stays the innermost
    range over its kernels (the trace mirrors only the innermost range on
    the device)."""
    mesh = model.mesh
    fsdp = mesh is not None and model.mode == "fsdp"
    axes = () if mesh is None else row_axes(mesh, model.mode)
    n = math.prod(MeshSpec.of(mesh).shape[a] for a in axes)

    def reduce(tensors: dict, summed: dict) -> None:
        """Sum each of ``tensors`` over the row axes but those ``summed``
        names for it (the axes a gather's backward summed it over), and
        divide it by the rows' ranks."""
        for key, t in tensors.items():
            for a in axes:
                if a not in summed.get(key, ()):
                    with counting.backend(a):
                        dist.all_reduce(t, group=mesh.get_group(a))
            t.div_(n)

    def train_step(state, batch):
        with telemetry.span("train.step", allocator=model.device):
            batch, split = _shard(model, batch)
            on_mesh = model.on_mesh(train=True, split=split)
            params = state["params"]
            for p in params.values():
                p.grad = None
            with on_mesh:
                with telemetry.span("train.forward", device=model.device):
                    loss, metrics = model.train_loss(batch)
                with telemetry.span("train.backward", device=model.device):
                    loss.backward()
            grads = {n_: p.grad for n_, p in params.items()}
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            if fsdp or n > 1:
                with telemetry.span("train.reduce"):
                    reduce({**grads, **metrics},
                           {k: spec_axes(s) for k, s in
                            model.sharded.items()} if fsdp else {})
            with telemetry.span("train.optimizer", device=model.device):
                om = opt.update(grads, state["opt"], params, mesh,
                                model.sharded)
            for p in params.values():
                p.grad = None
            metrics.update(om)
        return state, metrics

    return train_step


def _shard(model: Model, batch: dict) -> tuple[dict, tuple | None]:
    """The rank's part of a whole batch on the model's mesh, and the axes
    its rows and its sequence lie over with the leaves that lie whole
    (``split_batch``); the batch and None without a mesh."""
    if model.mesh is None:
        return batch, None
    part, *split = split_batch(batch, model.mesh, model.mode)
    return part, tuple(split)


def make_prefill_step(model: Model):
    """The prompt in, as the reference's ``make_prefill_step``
    (``repro/launch/steps.py:28-33``): returns (the greedy next token of
    each row, (B,) int64, and the cache).  On a mesh ``batch`` is the
    whole batch, sharded as ``make_train_step`` shards it: the rank's rows
    come back, and where the sequence is split each rank of its axes
    returns the whole prompt's token and cache (k/v of every position, the
    mamba states at its end, ``pos`` its length), which decode reads as
    that of an unsplit prefill."""
    def prefill_step(batch):
        batch, split = _shard(model, batch)
        with model.on_mesh(split=split):
            logits, cache = model.prefill(batch)
            return model.greedy(logits), cache

    return prefill_step


def make_serve_step(model: Model, whole: bool = False):
    """One decode step, as the reference's ``make_serve_step``
    (``repro/launch/steps.py:36-41``): token in, greedy token out, cache
    updated in place.

    On a mesh ``tokens`` is the whole batch's (B, 1), and ``cache`` the
    rank's part (``Model.cache_part``, or the cache of a prefill step's
    rows), as the reference's decode cell lays both out
    (``repro/launch/dryrun.py:94-104``): the step keeps the rank's rows of
    the tokens (over the batch axes where they divide B, else whole on
    every rank; "tp" mode's layout whatever the model's mode), installs the
    rows and the cache's positions where ``launch/shardings.
    decode_cache_specs`` lays them over the batch axes (B not a multiple of
    them: context-parallel decode, ``_positions``, ``model.on_mesh(split=
    (rows, (), (), cache))``), and returns the rank's
    greedy tokens (B_loc, 1) and cache.  The whole cache's positions are
    taken to be the part's times the batch axes' ranks (xk/xv's the
    config's encoder positions), as ``Model.cache_part`` cuts them.  With
    ``whole`` the tokens and the cache are every row's and every position's
    on every rank (``Model.init_decode_cache``'s, which the serving engine
    keeps alike on every rank, or a cache the rules keep whole) and are
    decoded whole.  A cache of other rows, or whose kv heads, conv
    channels or ssm heads are not the rank's (``Model.cache_part``'s,
    ``lm.kv_heads``, ``lm.state_parts``), raises."""
    def serve_step(tokens, cache):
        split = None
        if model.mesh is not None:
            _check_heads(model, cache)
        if model.mesh is not None and not whole:
            part, rows, _, _ = split_batch({"tokens": tokens}, model.mesh,
                                           "tp")
            mine, held = part["tokens"].shape[0], cache["pos"].shape[0]
            if held != mine:
                raise ValueError(f"a cache of {held} rows beside "
                                 f"{tokens.shape[0]} tokens: want the "
                                 f"rank's {mine} rows (Model.cache_part), "
                                 f"or whole=True for every row")
            split = (rows, (), (), _positions(model, cache, tokens.shape[0]))
            tokens = part["tokens"]
        with model.on_mesh(split=split):
            logits, cache = model.decode_step(tokens, cache)
            return model.greedy(logits)[:, None], cache

    return serve_step


def _check_heads(model: Model, cache: dict) -> None:
    """Raises unless the k/v leaves of ``cache`` hold the rank's kv heads,
    and its conv and ssm leaves the rank's channels and heads, on the
    model's mesh (``lm.kv_heads``, ``lm.state_parts``)."""
    cfg = model.cfg
    with model.on_mesh():
        want = {key: (3, kv_heads(cfg), "kv heads", cfg.n_kv_heads)
                for key in ("k", "v", "xk", "xv")}
        if "conv" in cache:
            for (key, (dim, whole)), n, what in zip(
                    state_whole(cfg).items(), state_parts(cfg),
                    ("channels", "ssm heads")):
                want[key] = (dim, n, what, whole)
    for key, (dim, n, what, whole) in want.items():
        if key in cache and cache[key].shape[dim] != n:
            raise ValueError(
                f"a cache of {cache[key].shape[dim]} {what} in {key}: want "
                f"the rank's {n} of {whole} (Model.cache_part)")


def _positions(model: Model, cache: dict, batch: int) -> tuple:
    """((leaf, axes), ...): the k/v/xk/xv leaves of ``cache`` whose
    positions lie over the batch axes, as ``cache_shardings`` lays a batch
    of ``batch`` rows that they do not divide: k/v always, xk/xv where
    they divide the encoder's positions; none where they divide it."""
    axes = batch_axes(model.mesh)
    n = math.prod(MeshSpec.of(model.mesh).shape[a] for a in axes)
    if batch % n == 0 and batch >= n:
        return ()
    return tuple((key, axes) for key in ("k", "v", "xk", "xv")
                 if key in cache and (key in ("k", "v")
                                      or model.cfg.enc_len % n == 0))
