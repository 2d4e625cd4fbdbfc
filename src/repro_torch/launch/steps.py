"""Step functions run by the serving engine.

The train step comes with the training slice, the prefill step with the
dry-run that calls it (ROADMAP.md, queue 1)."""
from __future__ import annotations

import torch

from ..models import Model


def make_serve_step(model: Model):
    """One decode step: token in, greedy token out, cache updated in place."""
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(tokens, cache)
        return torch.argmax(logits, dim=-1)[:, None], cache

    return serve_step
