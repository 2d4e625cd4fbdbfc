"""Meta-tensor stand-ins for every model input: the shapes and dtypes of the
reference's ``launch/input_specs.py``, with no memory.

``batch_specs(cfg, shape)`` returns the batch dict for train/prefill, or the
decode step's tokens; ``cache_specs(cfg, shape)`` the decode cache, built by
``Model(cfg, device="meta").init_decode_cache``, or with a mesh the rank's
part of it (``launch/shardings.decode_cache_specs``).  The steps take the
whole batch on a mesh and cut the rank's part themselves;
``rank_bytes`` gives the bytes of that part.  Modality frontends are
stubs, as in the reference: whisper gets precomputed frame embeddings,
llava gets patch features.  Tokens are int64, as the port's batches are
(``models/api.py``); the reference's are int32.
"""
from __future__ import annotations

import math

import torch

from ..models import Model
from ..models.common import dtype_of
from ..models.config import ArchConfig
from ..models.lm import PATCH_DIM
from .shapes_util import ShapeSpec
from .shardings import batch_shardings, decode_cache_specs, local_shape

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if shape.kind == "decode":
        return {"tokens": _spec((b, 1), torch.int64)}
    out: dict = {}
    if cfg.family == "encdec":
        out["frames"] = _spec((b, cfg.enc_len, cfg.d_model), cdt)
        out["tokens"] = _spec((b, s), torch.int64)
    elif cfg.family == "vlm":
        text = max(s - cfg.n_patches, 16)
        out["tokens"] = _spec((b, text), torch.int64)
        out["patches"] = _spec((b, cfg.n_patches, PATCH_DIM), cdt)
    else:
        out["tokens"] = _spec((b, s), torch.int64)
    if shape.kind == "train":
        out["labels"] = _spec(out["tokens"].shape, torch.int64)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                mode: str = "tp") -> dict:
    """The whole decode cache, or on ``mesh`` the rank's part of it in
    ``mode``'s layout."""
    whole = Model(cfg, device=META).init_decode_cache(shape.global_batch,
                                                      shape.seq_len)
    if mesh is None:
        return whole
    specs = decode_cache_specs(whole, cfg, mesh, mode)
    return {k: _spec(local_shape(v.shape, specs[k], mesh), v.dtype)
            for k, v in whole.items()}


def rank_bytes(batch: dict, mesh, mode: str = "tp") -> int:
    """The bytes of the rank's part of a whole ``batch`` that a step on
    ``mesh`` keeps, ``batch_shardings`` in ``mode`` (a decode step's tokens
    lie in "tp" mode's layout whatever the model's mode, as
    ``make_serve_step`` cuts them)."""
    specs = batch_shardings(batch, mesh, mode)
    return sum(math.prod(local_shape(v.shape, specs[k], mesh))
               * v.element_size() for k, v in batch.items())
