"""Step functions run by the trainer, the serving engine and the dry run
(``launch/dryrun.py``)."""
from __future__ import annotations

import math

import torch.distributed as dist

from ..models import Model
from ..models.common import use_mesh
from ..optim import AdamW
from .mesh import MeshSpec, batch_axes


def make_train_step(model: Model, opt: AdamW):
    """One optimizer step on one batch, as the reference's
    ``make_train_step`` (``repro/launch/steps.py:11-25``).  ``state`` is
    {"params": {name: parameter}, "opt": the optimizer's state}; both are
    updated in place and returned with the metrics "loss", the loss's own
    ("ce", and "aux" for every family but the encoder-decoder), "lr" and
    "grad_norm" (0-d tensors).  ``batch`` is what ``Model.train_loss``
    takes: tokens and labels, and frames (whisper) or patches (llava).

    On a mesh (``model.mesh``) the batch is the rank's rows
    (``launch/shardings.shard_batch``): the forward and backward run under
    ``use_mesh``, every gradient and the loss's metrics are then averaged
    over the batch axes when they hold more than one rank (data
    parallelism), and AdamW's clip sums the
    sharded leaves' norms over "model".  Tensor and expert parallelism
    leave each rank of "model" the gradient of its slices and the whole
    gradient of every replicated leaf ("f" and "g",
    ``launch/collectives.py``), so nothing is summed over it."""
    mesh = model.mesh
    baxes = () if mesh is None else batch_axes(mesh)
    nb = math.prod(MeshSpec.of(mesh).shape[a] for a in baxes)

    def average(tensors: list) -> None:
        for t in tensors:
            for a in baxes:
                dist.all_reduce(t, group=mesh.get_group(a))
            t.div_(nb)

    def train_step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        with use_mesh(mesh, model.mode):
            loss, metrics = model.train_loss(batch)
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if nb > 1:
            average([*grads.values(), *metrics.values()])
        om = opt.update(grads, state["opt"], params, mesh, model.sharded)
        for p in params.values():
            p.grad = None
        metrics.update(om)
        return state, metrics

    return train_step


def make_prefill_step(model: Model):
    """The prompt in, as the reference's ``make_prefill_step``
    (``repro/launch/steps.py:28-33``): returns (the greedy next token of
    each row, (B,) int64, and the cache)."""
    def prefill_step(batch):
        logits, cache = model.prefill(batch)
        return model.greedy(logits), cache

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: token in, greedy token out, cache updated in place."""
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(tokens, cache)
        return model.greedy(logits)[:, None], cache

    return serve_step
