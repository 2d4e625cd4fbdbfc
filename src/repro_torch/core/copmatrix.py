"""Twin of the batched COP drain's winner reduction, in PyTorch.

The reference scheduler's blocked step-2 kernel picks, among the candidate
nodes of a task, the one with the least key (missing bytes, or the
locality-weighted cost), ties broken by the least node id: a staged
reduction, min key first, then min id among the ties.  ``repro/core/
copmatrix.py::_jax_winner`` offers it as a jitted JAX twin; this is the
same reduction on a torch device.

    winner = torch_winner("cuda")        # or "cpu"
    node = winner(key, ids)              # numpy float64 or int64 keys

Keys stay in float64 or int64: f32 rounding would merge ties that the
scheduler's tuple compare keeps apart.  Inputs are padded to the next power
of two (pad key +inf for float keys, int64 max for int keys; pad id int64
max), as the JAX twin pads them to bound its traces; a pad never wins,
because a real key is never above the pad key and a real id always below
the pad id.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.common import require_device

KEY_DTYPES = (np.float64, np.int64)
_BIG = np.iinfo(np.int64).max


def _pad(key: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = len(key)
    padded = 1 << max(0, (n - 1).bit_length())
    if padded == n:
        return key, ids
    fill = np.inf if key.dtype.kind == "f" else _BIG
    return (np.concatenate([key, np.full(padded - n, fill, key.dtype)]),
            np.concatenate([ids, np.full(padded - n, _BIG, ids.dtype)]))


def torch_winner(device="cuda"):
    """A callable ``(key, ids) -> int``: the least id among the entries of
    least key, computed on ``device`` (CUDA unless the caller names another;
    raises if CUDA is asked for and absent).  ``key`` is a float64 or int64
    numpy array, ``ids`` an int64 array of the same length; any other dtype
    is refused."""
    device = require_device(device)

    def winner(key: np.ndarray, ids: np.ndarray) -> int:
        if key.dtype not in KEY_DTYPES:
            raise TypeError(f"torch_winner takes float64 or int64 keys; got "
                            f"{key.dtype}")
        if ids.dtype != np.int64 or ids.shape != key.shape:
            raise TypeError(f"ids must be int64 of the keys' shape "
                            f"{key.shape}; got {ids.dtype} {ids.shape}")
        key, ids = _pad(key, ids)
        k = torch.from_numpy(key).to(device)
        i = torch.from_numpy(ids).to(device)
        tie = k == k.min()
        return int(torch.where(tie, i, torch.full_like(i, _BIG)).min())

    return winner
