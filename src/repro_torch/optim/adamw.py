"""AdamW with a global-norm clip, warmup then cosine schedule, bias-corrected
moments in a configurable dtype (bf16 moments let a 7B model train on one
80 GB card), and optional bf16 gradient compression with error feedback.

A port of the reference's ``repro/optim/adamw.py``, written by hand because
``torch.optim.AdamW`` computes another update (no global clip, decay on
every tensor, moments in the parameters' dtype).  The arithmetic is the
reference's, in the same order and in f32, and the new parameter is cast
to its dtype once.  Unlike the reference, which returns new trees, the
update is **in place**, leaf by leaf and chunk by chunk: the f32
temporaries cover one chunk of one leaf, never a whole stacked leaf.

    opt = AdamW(AdamWConfig(moment_dtype="bfloat16"))
    state = opt.init(params)                  # params: {name: tensor}
    metrics = opt.update(grads, state, params)   # params, state in place
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..launch.collectives import all_reduce
from ..roofline import counting

_CHUNK = 1 << 24          # elements of one leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # float32 | bfloat16
    # gradient compression for the data-parallel all-reduce: "none" or
    # "bf16_ef" (grads cast to bf16, the rounding residual kept in an
    # error-feedback buffer so that its bias does not accumulate)
    grad_compression: str = "none"


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, in f32: linear warmup, then cosine
    down to a floor of 0.1 * lr."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _chunks(x: torch.Tensor):
    """Flat views of ``x`` (contiguous) in chunks of ``_CHUNK`` elements."""
    flat = x.view(-1)
    for i in range(0, max(flat.numel(), 1), _CHUNK):
        yield flat[i:i + _CHUNK]


class AdamW:
    def __init__(self, cfg: AdamWConfig | None = None) -> None:
        self.cfg = cfg or AdamWConfig()

    def init(self, params: dict) -> dict:
        """Zero moments (and error-feedback buffers) beside each leaf, and
        the step count, a 0-d int32."""
        mdt = _MOMENT_DTYPES[self.cfg.moment_dtype]
        any_p = next(iter(params.values()))

        def zeros(dtype):
            return {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                    for n, p in params.items()}

        state = {"m": zeros(mdt), "v": zeros(mdt),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=any_p.device)}
        if self.cfg.grad_compression == "bf16_ef":
            state["ef"] = zeros(torch.bfloat16)
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, mesh=None,
               sharded=frozenset()) -> dict:
        """One step: updates ``params`` and ``state`` in place; returns
        {"lr", "grad_norm"} (0-d f32; the norm before the clip).  A
        ``roofline.counting.Counter`` books its work as "optimizer".

        On a ``mesh``, the leaves named in ``sharded`` are this rank's
        slices over "model" (``Model.sharded``): their squared norms are
        summed over "model", every other leaf counted once, so the clip
        takes the norm one process would.  The moments are the slices'."""
        with counting.region(counting.OPTIMIZER):
            return self._update(grads, state, params, mesh, sharded)

    def _update(self, grads: dict, state: dict, params: dict, mesh,
                sharded) -> dict:
        cfg = self.cfg
        if cfg.grad_compression == "bf16_ef":
            # compress: g_c = bf16(g + ef);  ef' = (g + ef) - g_c
            compressed = {}
            for n, g in grads.items():
                corrected = g.float() + state["ef"][n].float()
                gc = corrected.to(torch.bfloat16)
                state["ef"][n].copy_(corrected - gc.float())
                compressed[n] = gc
            grads = compressed
        state["count"] += 1
        count = state["count"].to(torch.float32)
        lr = schedule(cfg, count)
        # global-norm clip in f32, summed leaf by leaf in the tree's order
        sq = {n: sum(c.float().square().sum() for c in _chunks(g.contiguous()))
              for n, g in grads.items()}
        split = [n for n in sq if n in sharded]
        if mesh is not None and split:
            for n, total in zip(split, all_reduce(
                    torch.stack([sq[n] for n in split]), mesh, "model")):
                sq[n] = total
        gnorm = torch.sqrt(sum(sq.values()))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        b1c = 1.0 - torch.pow(cfg.b1, count)
        b2c = 1.0 - torch.pow(cfg.b2, count)
        for n, p in params.items():
            decay = p.dim() >= 2     # decoupled weight decay on matrices only
            for g, m, v, w in zip(_chunks(grads[n].contiguous()),
                                  _chunks(state["m"][n]),
                                  _chunks(state["v"][n]), _chunks(p.data)):
                g32 = g.float() * scale
                m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
                v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
                mh = m32 / b1c
                vh = v32 / b2c
                step = mh / (torch.sqrt(vh) + cfg.eps)
                if decay:
                    step = step + cfg.weight_decay * w.float()
                w.copy_(w.float() - lr * step)
                m.copy_(m32)
                v.copy_(v32)
        return {"lr": lr, "grad_norm": gnorm}
