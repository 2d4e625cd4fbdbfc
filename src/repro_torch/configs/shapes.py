"""Assigned input shapes (one set shared by all 10 LM-family archs), a copy
of the JAX package's table.

    train_4k     seq 4,096    global_batch 256   -> train_step
    prefill_32k  seq 32,768   global_batch 32    -> prefill_step
    decode_32k   seq 32,768   global_batch 128   -> serve_step (1 new token,
                                                    KV/state of seq_len)
    long_500k    seq 524,288  global_batch 1     -> serve_step; only for
                                                    sub-quadratic archs
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per DESIGN.md §4."""
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, ("pure full-attention arch: 500k context is "
                       "quadratic-infeasible; skipped per assignment rules")
    return True, ""
