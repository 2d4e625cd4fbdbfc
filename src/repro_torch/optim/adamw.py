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

On a mesh the moments are the rank's slices, as its parameters are ("tp"
and "fsdp" alike); with ``init(params, model, zero1=True)`` a "tp" model's
moments are the rank's slices of the reference's ZeRO-1 specs
(``launch/shardings.opt_shardings(..., zero1=True)``: each moment's largest
unsplit dim over "data" besides), and ``update`` updates the rank's part
of each such leaf and all-gathers the parts over "data".
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..launch.collectives import all_reduce, gather_leaf
from ..launch.mesh import coordinate
from ..launch.shardings import local_shape, opt_shardings, spec_axes
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

    def init(self, params: dict, model=None, zero1: bool = False) -> dict:
        """Zero moments (and error-feedback buffers) beside each leaf, and
        the step count, a 0-d int32.  With ``zero1`` (the reference's
        argument of ``opt_shardings``), ``model`` on a mesh: each moment is
        the rank's part of ``opt_shardings(..., zero1=True)``'s spec, which
        in "fsdp" mode is the parameter's own."""
        mdt = _MOMENT_DTYPES[self.cfg.moment_dtype]
        any_p = next(iter(params.values()))
        shapes = {n: p.shape for n, p in params.items()}
        if zero1:
            if model is None or model.mesh is None:
                raise ValueError("ZeRO-1 slices the moments over a mesh's "
                                 "\"data\" axis: pass the model on a mesh")
            specs = opt_shardings(model.whole_shapes, model.mesh, zero1=True,
                                  mode=model.mode)["m"]
            shapes = {n: local_shape(model.whole_shapes[n], specs[n],
                                     model.mesh) for n in params}

        def zeros(dtype, shapes=shapes):
            return {n: torch.zeros(shapes[n], dtype=dtype, device=p.device)
                    for n, p in params.items()}

        state = {"m": zeros(mdt), "v": zeros(mdt),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=any_p.device)}
        if self.cfg.grad_compression == "bf16_ef":
            state["ef"] = zeros(torch.bfloat16, {n: p.shape for n, p in
                                                 params.items()})
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, mesh=None,
               sharded=None) -> dict:
        """One step: updates ``params`` and ``state`` in place; returns
        {"lr", "grad_norm"} (0-d f32; the norm before the clip).  A
        ``roofline.counting.Counter`` books its work as "optimizer".

        On a ``mesh``, the leaves named in ``sharded`` ({name: spec},
        ``Model.sharded``) are this rank's slices: their squared norms are
        summed over the axes their specs name, every other leaf counted
        once, so the clip takes the norm one process would.  The moments
        are the slices'.  A moment smaller than its parameter is the rank's
        ZeRO-1 part over "data" (``init(..., zero1=True)``): the rank
        updates its part of the parameter and the parts are all-gathered
        over "data"; the update is elementwise, so the parameters are those
        of the same mesh without ZeRO-1, bit for bit."""
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
        by_axes: dict = {}
        for n in sq:
            if mesh is not None and n in (sharded or {}):
                by_axes.setdefault(spec_axes(sharded[n]), []).append(n)
        for axes, split in by_axes.items():
            for n, total in zip(split, all_reduce(
                    torch.stack([sq[n] for n in split]), mesh, axes)):
                sq[n] = total
        gnorm = torch.sqrt(sum(sq.values()))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        for n, p in params.items():
            grad, new = grads[n], p.data
            part = _zero1_part(p, state["m"][n], mesh)
            if part is not None:
                grad, new = grad.narrow(*part), new.narrow(*part).contiguous()
            self.leaf_update(grad, state["m"][n], state["v"][n], new, scale,
                             lr, count)
            if part is not None:
                p.data.copy_(gather_leaf(new, mesh, part[0], "data"))
        return {"lr": lr, "grad_norm": gnorm}

    def leaf_update(self, grad, m, v, w, scale, lr, count) -> None:
        """One leaf's step, in place on ``m``, ``v`` and ``w`` (contiguous,
        of ``grad``'s shape), at the clip's ``scale``, the schedule's ``lr``
        and the step ``count`` (f32).  Elementwise, chunk by chunk: a part of
        a leaf updated alone (ZeRO-1's) is that part of the whole leaf's
        update, bit for bit.  Decoupled weight decay on matrices only."""
        cfg = self.cfg
        b1c = 1.0 - torch.pow(cfg.b1, count)
        b2c = 1.0 - torch.pow(cfg.b2, count)
        decay = w.dim() >= 2
        for g, mc, vc, wc in zip(_chunks(grad.contiguous()), _chunks(m),
                                 _chunks(v), _chunks(w)):
            g32 = g.float() * scale
            m32 = cfg.b1 * mc.float() + (1 - cfg.b1) * g32
            v32 = cfg.b2 * vc.float() + (1 - cfg.b2) * g32 * g32
            mh = m32 / b1c
            vh = v32 / b2c
            step = mh / (torch.sqrt(vh) + cfg.eps)
            if decay:
                step = step + cfg.weight_decay * wc.float()
            wc.copy_(wc.float() - lr * step)
            mc.copy_(m32)
            vc.copy_(v32)


def _zero1_part(p: torch.Tensor, m: torch.Tensor, mesh):
    """(dim, start, length): the rank's part of ``p`` that its ZeRO-1
    moment ``m`` covers, the dim that "data" splits; None where the moment
    is the parameter's shape."""
    if m.shape == p.shape:
        return None
    dims = [d for d in range(p.dim()) if m.shape[d] != p.shape[d]]
    if mesh is None or len(dims) != 1:
        raise ValueError(f"a moment {tuple(m.shape)} beside a parameter "
                         f"{tuple(p.shape)} is no ZeRO-1 part over a mesh's "
                         f"\"data\" axis")
    d = dims[0]
    return d, coordinate(mesh)["data"] * m.shape[d], m.shape[d]
