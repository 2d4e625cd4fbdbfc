"""The collectives of expert and tensor parallelism, each with the gradient
that makes a training step's gradients those of one process.

The reference gets them from ``jax.lax`` inside ``shard_map`` (``psum``,
``all_to_all``), whose transposes JAX derives.  Here each is an autograd
Function over one axis of a DeviceMesh (``mesh.get_group(axis)``):

    all_reduce   sum forward, gradient passed on unchanged (scaled by
                 ``grad_scale``): a sum every rank then uses alike
                 (Megatron's "g")
    copy_to      identity forward, sum of the gradients backward: where a
                 value every rank holds alike enters rank-local work
                 (Megatron's "f"), so that its gradient gathers every
                 rank's share
    all_to_all   ``jax.lax.all_to_all(..., tiled=True)``: split one dim
                 among the ranks, concatenate what arrives along another
    seq_slice    this rank's slice of a dim forward, the slices gathered
                 backward
    seq_gather   the slices gathered forward, this rank's slice of the
                 gradient backward
    gather_leaf  a leaf held in slices over one axis or a tuple of axes
                 along one dim, gathered whole forward (fsdp's ZeRO-3
                 gather); backward, the gradients of every rank of those
                 axes summed and each rank's part kept (reduce-scatter):
                 each rank computes on other rows, so the ranks' gradients
                 of the whole leaf are shares of the step's
    scatter_sum  its transpose: the ranks' tensors summed and each rank's
                 part kept forward, the parts gathered backward
    exchange_columns
                 a leaf held in contiguous slices of one dim: each rank
                 gets the ranges of that dim it names (``column_plan``),
                 wherever they lie, by one all-to-all of parts of unequal
                 size; backward, the reverse exchange, the gradient of a
                 column that several ranks took summed into its holder
                 (mamba's packed projections, ``models/ssm.py``)

and, over a sequence whose contiguous slices lie on the ranks of one or
more axes (an "fsdp" batch smaller than the mesh, ``models/common.
seq_split``), on ``gather_leaf``, whose backward sums what every rank's
later work read:

    seq_halo     the rows just before this rank's slice (a causal conv's
                 halo), zeros before the first token
    seq_last     one rank's tensor (the last's, or the holder's of the
                 last real position), on every rank
    gather_parts every rank's tensor, stacked in rank order on every
                 rank: context-parallel decode's partial softmax sums
                 (``models/attention.py``), combined in that order, so
                 that every rank gets the same bits, which an
                 all-reduce's order of addition may not give

"tp" mode gathers a leaf that every rank of "model" uses whole on the same
rows (llava's projector; mamba's where its heads do not divide "model")
with ``seq_gather``: there every rank's
gradient of the whole leaf is the same, and the rank keeps its own slice.

and, over the vocabulary's slices of "model" (``lm.py``'s head in "tp"
mode):

    vocab_cross_entropy  ``models/common.cross_entropy_loss`` of logits
                         held as (B, S, V/nm) slices
    vocab_argmax         the greedy token of such logits

``torch.distributed.nn.functional.all_reduce`` sums the gradient too: when
every rank computes the same loss that multiplies it by the axis's size,
so "g" is not built on it.  The tensors go to the group's backend as they
are: NCCL for CUDA, gloo for the CPU (``launch/mesh.py``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import (
    all_to_all_single, all_to_all_single_autograd, wait_tensor)

from ..kernels._layout import dense_strides
from ..roofline import counting


class _Axis(NamedTuple):
    """A mesh axis's process group and its name, which a counter books the
    collective under (two axes of one rank share the world's group)."""
    group: object
    name: str


def _axis(mesh, axis: str) -> _Axis:
    return _Axis(mesh.get_group(axis), axis)


def _sum(x: torch.Tensor, ax: _Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    with counting.backend(ax.name):
        dist.all_reduce(out, op=op, group=ax.group)
    return out


# torch 2.13 renames all_gather_into_tensor and reduce_scatter_tensor;
# older versions have only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _gather(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order: gathered
    into one buffer, the ranks' parts one after another, then laid along
    ``dim`` by whole blocks (no copy when ``dim`` is 0 or the group has
    one rank)."""
    x = x.contiguous()
    dim, n = dim % x.dim(), dist.get_world_size(ax.group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    with counting.backend(ax.name):
        _ALL_GATHER(out, x, group=ax.group)
    return dense_strides(out.view(n, *x.shape).movedim(0, dim)
                         .flatten(dim, dim + 1).contiguous())


def _scatter(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, cut along ``dim`` into one
    part a rank in rank order, and this rank's part (contiguous): the parts
    laid one after another, whole blocks copied (no copy when ``dim`` is 0
    or the group has one rank), reduce-scattered into the rank's part."""
    dim, n = dim % x.dim(), dist.get_world_size(ax.group)
    parts = x.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
    out = parts.new_empty(parts.shape[1:])
    with counting.backend(ax.name):
        _REDUCE_SCATTER(out, parts.flatten(0, 1), group=ax.group)
    return out


def _own(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    n = dist.get_world_size(ax.group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(ax.group) * size, size)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.grad_scale != 1.0:
            grad = grad * ctx.grad_scale
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _SeqSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.dim, ctx.group), None, None


class _LeafGather(torch.autograd.Function):
    """Gathered over ``groups`` (major axis first) along ``dim``, the minor
    axis first, so that the parts come in ``launch/shardings.local_slice``'s
    order; the backward reduce-scatters in the reverse order."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for group in reversed(groups):
            x = _gather(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        for group in ctx.groups:
            grad = _scatter(grad, ctx.dim, group)
        return grad, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for group in groups:
            x = _scatter(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        for group in reversed(ctx.groups):
            grad = _gather(grad, ctx.dim, group)
        return grad, None, None


@functools.lru_cache(maxsize=None)
def column_plan(index: int, held: int, want: tuple) -> tuple:
    """The plan of ``exchange_columns`` for the rank at ``index`` of
    ``len(want)`` ranks, each of which holds ``held`` contiguous columns of
    a whole (rank q columns [q held, (q+1) held)) and wants the columns
    ``want[q]``, ascending disjoint (start, stop) ranges of the whole:
    (send, send_sizes, recv_sizes).  ``send`` is the (start, length) runs
    of the rank's own columns in the order they go out: rank 0's first,
    each rank's in the order of its ranges; ``send_sizes[s]`` counts those
    that go to rank s, ``recv_sizes[q]`` those that come from rank q,
    which arrive in rank order, so in the order of ``want[index]``."""
    lo, hi = index * held, (index + 1) * held
    send, send_sizes = [], []
    for ranges in want:
        size = 0
        for a, b in ranges:
            a, b = max(a, lo), min(b, hi)
            if a < b:
                send.append((a - lo, b - a))
                size += b - a
        send_sizes.append(size)
    recv_sizes = tuple(sum(max(0, min(b, (q + 1) * held) - max(a, q * held))
                           for a, b in want[index])
                       for q in range(len(want)))
    return tuple(send), tuple(send_sizes), recv_sizes


def _all_to_all_v(x: torch.Tensor, dim: int, recv: tuple, send: tuple,
                  ax: _Axis) -> torch.Tensor:
    """``x``'s first send[0] entries of ``dim`` to rank 0, the next send[1]
    to rank 1, ...; what arrives, recv[q] entries from rank q, laid along
    ``dim`` in rank order.  Contiguous."""
    with counting.backend(ax.name):
        out = wait_tensor(all_to_all_single(
            x.movedim(dim, 0).contiguous(), list(recv), list(send),
            ax.group))
    return dense_strides(out.movedim(0, dim).contiguous())


class _ColumnExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, plan):
        send, send_sizes, recv_sizes = plan
        ctx.dim, ctx.ax, ctx.plan, ctx.shape = dim, ax, plan, x.shape
        out = torch.cat([x.narrow(dim, a, n) for a, n in send], dim) \
            if send else x.narrow(dim, 0, 0)
        return _all_to_all_v(out, dim, recv_sizes, send_sizes, ax)

    @staticmethod
    def backward(ctx, grad):
        send, send_sizes, recv_sizes = ctx.plan
        back = _all_to_all_v(grad, ctx.dim, send_sizes, recv_sizes, ctx.ax)
        dx = back.new_zeros(ctx.shape)
        at = 0
        for a, n in send:            # a column sent to several ranks sums
            dx.narrow(ctx.dim, a, n).add_(back.narrow(ctx.dim, at, n))
            at += n
        return dx, None, None, None


def _groups(mesh, axes) -> tuple:
    return tuple(_axis(mesh, a) for a in
                 ((axes,) if isinstance(axes, str) else tuple(axes)))


def all_reduce(x: torch.Tensor, mesh, axes,
               grad_scale: float = 1.0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple of
    names of ``mesh``); the gradient passes back times ``grad_scale``."""
    for axis in (axes,) if isinstance(axes, str) else tuple(axes):
        x = _AllReduce.apply(x, _axis(mesh, axis), grad_scale)
        grad_scale = 1.0
    return x


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _CopyTo.apply(x, _axis(mesh, axis))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``split_dim`` cut into one part a rank of ``axis`` (part i goes to
    rank i); the parts that arrive concatenated along ``concat_dim`` in
    rank order.  Contiguous; its backward is the reverse exchange."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    parts = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    with counting.backend(axis):
        out = wait_tensor(all_to_all_single_autograd(parts.contiguous(),
                                                     None, None, group))
    return dense_strides(out.movedim(0, concat_dim).flatten(
        concat_dim, concat_dim + 1).contiguous())


def exchange_columns(x: torch.Tensor, mesh, axis: str, dim: int,
                     want: tuple) -> torch.Tensor:
    """The columns ``want[r]`` ((start, stop) ranges, ascending) of the
    whole of which ``x`` is this rank's contiguous slice along ``dim`` over
    ``axis`` (rank r of n holds [r s, (r+1) s) of n s), in their order,
    for the rank at r; ``want`` lists every rank's ranges.  One
    all-to-all (``column_plan``); backward, the reverse exchange, each of
    this rank's columns' gradient summed over the ranks that took it.
    Over an axis of one rank it copies the ranges."""
    dim = dim % x.dim()
    ax = _axis(mesh, axis)
    plan = column_plan(dist.get_rank(ax.group), x.shape[dim], tuple(want))
    return _ColumnExchange.apply(x, dim, ax, plan)


def seq_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _SeqSlice.apply(x, dim, _axis(mesh, axis))


def seq_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _SeqGather.apply(x, dim, _axis(mesh, axis))


def gather_leaf(x: torch.Tensor, mesh, dim: int,
                axes="model") -> torch.Tensor:
    """The whole leaf of which ``x`` is this rank's part along ``dim``
    over ``axes`` (a name, or a tuple of names with the first axis the
    major one, as a spec names them); backward, the sum of every rank's
    gradient of the whole leaf, of which the rank keeps its part.  Over an
    axis of one rank both are copies."""
    return _LeafGather.apply(x, dim, _groups(mesh, axes))


def seq_halo(x: torch.Tensor, mesh, axes, index: int,
             rows: int) -> torch.Tensor:
    """The ``rows`` rows of a sequence just before the slice ``x`` (B, s,
    ...) that the rank at ``index`` of ``axes`` holds (``models/common.
    seq_rank``), zeros before the first token: a causal conv's halo.  Each
    rank's last min(s, rows) rows are gathered (``gather_leaf``), so the
    halo's gradient flows back, summed, to the ranks whose rows they are.
    Every rank runs the same ops on the gathered rows, the first rank too,
    so that every rank's backward meets the reduce-scatter."""
    m = min(x.shape[1], rows)
    tails = gather_leaf(x.narrow(1, x.shape[1] - m, m), mesh, 1, axes)
    zeros = tails.new_zeros((tails.shape[0], rows, *tails.shape[2:]))
    return torch.cat([zeros, tails], dim=1).narrow(1, index * m, rows)


def seq_last(x: torch.Tensor, mesh, axes, index: int = -1) -> torch.Tensor:
    """The ``x`` of the rank at ``index`` over ``axes`` (``models/common.
    seq_rank``'s order; the last rank, the end of a split sequence, by
    default), alike on every rank; backward, every rank's gradient summed
    into that rank's.  Every rank passes an ``x`` of the same shape."""
    return gather_leaf(x[None], mesh, 0, axes)[index]


def gather_parts(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(n, *x.shape): the ``x`` of every rank of ``axes`` (a name, or a
    tuple of names with the first axis the major one), stacked in rank
    order (``models/common.seq_rank``'s), alike on every rank: one
    all-gather an axis, booked under it."""
    return gather_leaf(x[None], mesh, 0, axes)


def scatter_sum(x: torch.Tensor, mesh, dim: int, axes="model") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, of which the rank keeps
    its part along ``dim`` (``gather_leaf``'s order); backward, the parts
    of the gradient gathered."""
    return _ScatterSum.apply(x, dim, _groups(mesh, axes))


class _VocabCrossEntropy(torch.autograd.Function):
    """Mean CE of logits whose vocabulary is split over a group: the ranks'
    row maxima and sums of exponentials combined by all-reduces (max, then
    sum), the gold logit taken on the rank that holds the label.  The f32
    arithmetic is ``cross_entropy_loss``'s, op for op: ``torch.logsumexp``
    computes lse = log(sum(exp(x - max))) + max, and autograd of it and of
    the gold gather gives exp(x - lse) * g with -g added at the label, which
    the backward computes on each slice in the same order."""

    @staticmethod
    def forward(ctx, logits, labels, group, v0):
        x = logits.float()
        m = _sum(torch.amax(x, dim=-1, keepdim=True), group,
                 dist.ReduceOp.MAX)
        s = _sum(torch.sum(torch.exp(x - m), dim=-1), group)
        lse = s.log_().add_(m[..., 0])
        own = (labels >= v0) & (labels < v0 + x.shape[-1])
        idx = torch.where(own, labels - v0, 0).long()[..., None]
        gold = _sum(torch.gather(x, -1, idx)[..., 0] * own, group)
        ctx.save_for_backward(logits, lse, idx, own)
        ctx.n = lse.numel()
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, lse, idx, own = ctx.saved_tensors
        g = (grad / ctx.n).expand(lse.shape)
        d = torch.exp(logits.float() - lse[..., None]) * g[..., None]
        d.scatter_add_(-1, idx, (-g * own)[..., None])
        return d.to(logits.dtype), None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mesh) -> torch.Tensor:
    """``models/common.cross_entropy_loss(logits, labels)`` of the whole
    vocabulary, for ``logits`` (B, S, V/nm) this rank's slice over "model"
    (the rank at position r holds ids [r V/nm, (r+1) V/nm)); labels (B, S)
    of the whole vocabulary.  Every rank returns the loss, and keeps the
    gradient of its own slice."""
    ax = _axis(mesh, "model")
    v0 = dist.get_rank(ax.group) * logits.shape[-1]
    return _VocabCrossEntropy.apply(logits, labels, ax, v0)


def vocab_argmax(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The greedy token of logits (B, V/nm) held in vocabulary slices over
    "model": the slices gathered and ``torch.argmax`` taken on the whole
    rows, so ties go to the lowest id as on one process.  Alike on every
    rank."""
    return torch.argmax(_gather(logits, -1, _axis(mesh, "model")), dim=-1)
