"""Weight bridge: the JAX package's parameter tree, as numpy arrays, into
this package's state dict.

    state = params_from_jax(jax.device_get(jax_model.init(key)))
    model = Model(cfg, device="cpu").load_state(state)

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
