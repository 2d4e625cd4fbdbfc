"""Step functions run by the trainer, the serving engine and the dry run
(``launch/dryrun.py``)."""
from __future__ import annotations

import torch

from ..models import Model
from ..optim import AdamW


def make_train_step(model: Model, opt: AdamW):
    """One optimizer step on one batch, as the reference's
    ``make_train_step`` (``repro/launch/steps.py:11-25``).  ``state`` is
    {"params": {name: parameter}, "opt": the optimizer's state}; both are
    updated in place and returned with the metrics "loss", the loss's own
    ("ce", and "aux" for every family but the encoder-decoder), "lr" and
    "grad_norm" (0-d tensors).  ``batch`` is what ``Model.train_loss``
    takes: tokens and labels, and frames (whisper) or patches (llava)."""
    def train_step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        loss, metrics = model.train_loss(batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        om = opt.update(grads, state["opt"], params)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return state, metrics

    return train_step


def make_prefill_step(model: Model):
    """The prompt in, as the reference's ``make_prefill_step``
    (``repro/launch/steps.py:28-33``): returns (the greedy next token of
    each row, (B,) int64, and the cache)."""
    def prefill_step(batch):
        logits, cache = model.prefill(batch)
        return torch.argmax(logits, dim=-1), cache

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: token in, greedy token out, cache updated in place."""
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(tokens, cache)
        return torch.argmax(logits, dim=-1)[:, None], cache

    return serve_step
