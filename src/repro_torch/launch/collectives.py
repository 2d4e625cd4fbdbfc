"""The collectives of the expert-parallel MoE, each with the gradient that
makes a training step's gradients those of one process.

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

``torch.distributed.nn.functional.all_reduce`` sums the gradient too: when
every rank computes the same loss that multiplies it by the axis's size,
so "g" is not built on it.  The tensors go to the group's backend as they
are: NCCL for CUDA, gloo for the CPU (``launch/mesh.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import (
    all_to_all_single_autograd, wait_tensor)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


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


def all_reduce(x: torch.Tensor, mesh, axes,
               grad_scale: float = 1.0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple of
    names of ``mesh``); the gradient passes back times ``grad_scale``."""
    for axis in (axes,) if isinstance(axes, str) else tuple(axes):
        x = _AllReduce.apply(x, mesh.get_group(axis), grad_scale)
        grad_scale = 1.0
    return x


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _CopyTo.apply(x, mesh.get_group(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``split_dim`` cut into one part a rank of ``axis`` (part i goes to
    rank i); the parts that arrive concatenated along ``concat_dim`` in
    rank order.  Contiguous; its backward is the reverse exchange."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    parts = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    out = wait_tensor(all_to_all_single_autograd(parts.contiguous(), None,
                                                 None, group))
    return out.movedim(0, concat_dim).flatten(
        concat_dim, concat_dim + 1).contiguous()


def seq_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _SeqSlice.apply(x, dim, mesh.get_group(axis))


def seq_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _SeqGather.apply(x, dim, mesh.get_group(axis))
