"""Weight bridge: the JAX package's parameter tree (and its optimizer
state), as numpy arrays, into this package's state dicts.

    state = params_from_jax(jax.device_get(jax_model.init(key)))
    model = Model(cfg, device="cpu").load_state(state)
    opt_state = opt_state_from_jax(jax.device_get(jax_opt.init(params)))

Leaf by leaf: the nested dict's paths become dotted state-dict keys
(``layers.attn.wq``) and the stacked-over-layers layout is kept, so each
leaf is a plain copy.  bfloat16 leaves go through float32 in numpy (numpy
has no bfloat16 of its own) and are cast back in torch; float32 to
bfloat16 and back is exact.  This module never imports JAX: the caller
hands it numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.api import flatten


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())   # jax.device_get gives read-only arrays


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into {dotted name: tensor}."""
    return {name: _to_torch(leaf) for name, leaf in flatten(tree).items()}


def opt_state_from_jax(state: dict) -> dict:
    """The JAX ``AdamW`` state, as numpy arrays, in this package's layout:
    {"m": {dotted name: tensor}, "v": ..., "count": 0-d int32, and "ef"
    with bf16 gradient compression}."""
    out = {k: params_from_jax(v) for k, v in state.items()
           if isinstance(v, dict)}
    out["count"] = _to_torch(state["count"]).to(torch.int32)
    return out
