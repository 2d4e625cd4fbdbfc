"""Training cells: the port's ``make_train_step`` (what ``Trainer.step_fn``
runs) fed by its ``MemmapCorpus`` and ``PrefetchingLoader`` from a token
file that the harness writes from the seed.

Set-up builds one model and optimizer from the seed's weights and drives
them through the traffic's ``checked_steps`` first steps, through the
window's own call and feed; the window then runs whole steps of the same
objects for ``--seconds``.  Step i of the run reads rows [i n, (i + 1) n)
of the token file, n = batch (seq_len + 1), all different.

What decides ``correct`` (``compare``): the reference, given the same
weights and rows, runs the same first steps in float32; compared are
each step's loss, each leaf's norm of the first gradient as the optimizer
got it, and each leaf's norm of the change of the parameters over those
steps, as the window's first step finds them."""
from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from . import weights
from .common import sub_seed
from .reference import AdamWRef, Reference, leaf_specs
from .stats import whole_steps_rate
from .trace import label


def _rows(path: str, step: int, batch: int, seq: int):
    """The tokens and labels (B, S) of step ``step``, read from the file."""
    need = batch * (seq + 1)
    toks = np.load(path, mmap_mode="r")[step * need:(step + 1) * need]
    toks = torch.as_tensor(np.asarray(toks, dtype=np.int64)).reshape(
        batch, seq + 1)
    return toks[:, :-1], toks[:, 1:]


def write_tokens(directory: str, seed: int, vocab: int, batch: int, seq: int,
                 steps: int) -> str:
    rng = np.random.default_rng(sub_seed(seed, "tokens"))
    path = os.path.join(directory, "tokens.npy")
    np.save(path, rng.integers(0, vocab, size=steps * batch * (seq + 1),
                               dtype=np.int32))
    return path


def _norm(t: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """The float32 norm of ``t`` (less ``minus``), slice by slice of 2^24
    values, so that no float32 copy of a whole leaf is made."""
    flat = t.detach().reshape(-1)
    other = None if minus is None else minus.reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), 1 << 24):
        part = flat[i:i + (1 << 24)].float()
        if other is not None:
            part = part - other[i:i + (1 << 24)].float()
        total += float(part.square().sum())
    return total ** 0.5


def _norms(tensors: dict) -> dict:
    return {k: _norm(t) for k, t in tensors.items()}


def _change(params: dict, arch, seed: int) -> dict:
    """Each leaf's norm of its change from the seed's weights, drawn again
    leaf by leaf."""
    specs = leaf_specs(arch)
    out = {}
    for name, p in params.items():
        p0 = weights.draw_leaf(specs[name], seed, name, p.device)
        out[name] = _norm(p, p0)
        del p0
    return out


def run(ctx) -> None:
    from repro_torch.data import MemmapCorpus, PrefetchingLoader
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ArchConfig, Model
    from repro_torch.optim import AdamW, AdamWConfig

    tr, arch, seed = ctx.traffic, ctx.arch, ctx.seed
    batch, seq, checked = tr["batch"], tr["seq_len"], tr["checked_steps"]
    device = ctx.device
    model = Model(ArchConfig(**ctx.config["arch"]), device=device)
    model.load_state(weights.draw(arch, seed, device))
    opt = AdamW(AdamWConfig(**ctx.config["optimizer"]))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step_fn = make_train_step(model, opt)

    tmp = tempfile.mkdtemp(prefix="bench-tokens-")
    ctx.cleanup.append(tmp)
    path = write_tokens(tmp, seed, arch.vocab, batch, seq, tr["file_steps"])
    corpus = MemmapCorpus(path, shard_tokens=batch * (seq + 1))
    loader = PrefetchingLoader(
        corpus, batch, seq,
        to_device=lambda x: torch.as_tensor(x, dtype=torch.int64).to(device))
    ctx.closers.append(loader.close)

    # the checked first steps, through the window's own call and feed; the
    # first gradient as the optimizer gets it, read at its update
    got = {}
    update = opt.update

    def reading_update(grads, *args, **kw):
        if "grads" not in got:
            got["grads"] = _norms(grads)
        return update(grads, *args, **kw)

    opt.update = reading_update
    losses = []
    for _ in range(checked):
        state, metrics = step_fn(state, next(loader))
        losses.append(float(metrics["loss"]))
    del opt.update
    program = {"loss": losses, "grads": got["grads"],
               "change": _change(params, arch, seed)}

    if ctx.trace_on:
        ctx.wrap_kernels()
        update = opt.update

        def labelled_update(*args, **kw):
            with label("opt.update"):
                return update(*args, **kw)
        opt.update = labelled_update

    steps, waits, traced = [], [], []
    ctx.open_window()
    t0 = ctx.t0
    while True:
        ctx.trace_step(len(steps))
        with label("train.step"):
            a = time.perf_counter()
            with label("loader.next"):
                b = next(loader)
            w = time.perf_counter()
            state, metrics = step_fn(state, b)
            float(metrics["loss"])
            e = time.perf_counter()
        steps.append((a, e))
        waits.append(w - a)
        traced.append(ctx.tracer is not None and ctx.tracer.on)
        if e - t0 >= ctx.seconds:
            break
    ctx.close_window(steps[-1][1])
    ctx.values.update(train_steps=steps, loader_waits=waits, traced=traced,
                      tokens_per_step=batch * seq, batch=batch, seq=seq)
    ctx.attempted, ctx.failed = len(steps), 0
    ctx.end_to_end["train_tokens_per_s"] = whole_steps_rate(
        [e for _, e in steps], t0, batch * seq)

    ctx.read_memory()
    loader.close()
    if ctx.trace_on:
        del opt.update
    del state, params, step_fn, opt, model, metrics, b
    ctx.free()
    ref = reference_steps(ctx.config, arch, seed, path, batch, seq, checked,
                          device)
    ctx.values.update(program=program, reference=ref)
    ctx.checks = compare(program, ref, ctx.limits)


def reference_steps(config: dict, arch, seed: int, path: str, batch: int,
                    seq: int, steps: int, device, precision: str = "float32",
                    half_batch: bool = False) -> dict:
    """The reference's first ``steps`` steps from the seed's weights on the
    token file's rows: each loss, the first gradient's leaf norms, the
    change's leaf norms.  ``half_batch`` plants a fault: the loss is the
    mean over the first half of the rows (of the positions, for one row)."""
    params = weights.draw(arch, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    model = Reference(arch, params, precision)
    opt = AdamWRef(config["optimizer"], params)
    losses, first = [], None
    for i in range(steps):
        tokens, labels = (t.to(device) for t in _rows(path, i, batch, seq))
        if half_batch:
            if batch > 1:
                tokens, labels = tokens[:batch // 2], labels[:batch // 2]
            else:
                tokens, labels = tokens[:, :seq // 2], labels[:, :seq // 2]
        loss = model.train_loss(tokens, labels)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        if first is None:
            first = _norms(grads)
        opt.step(params, grads)
        for p in params.values():
            p.grad = None
        losses.append(float(loss.detach()))
        del loss, grads
    out = {"loss": losses, "grads": first,
           "change": _change(params, arch, seed)}
    del params, model, opt
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def gaps(program: dict, ref: dict) -> dict:
    """The numbers a training cell may compare: ``loss_gap`` the largest
    gap of a step's loss over the reference's, ``loss_first_gap`` the first
    step's; ``grad_gap`` and
    ``change_gap`` the largest gap of a leaf's norm (the first gradient's,
    the change's) over the larger of the reference leaf's and the median
    leaf's, and ``grad_median_gap``, ``change_median_gap`` the median
    leaf's gap.  Leaves whose reference gradient is under a thousandth of
    the median leaf's (moved by round-off alone) are left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["loss"],
                                                   ref["loss"]))
    med_g = statistics.median(ref["grads"].values())
    kept = [k for k, g in ref["grads"].items() if g >= 1e-3 * med_g]
    out = {"loss_gap": loss,
           "loss_first_gap": abs(program["loss"][0] - ref["loss"][0])
           / abs(ref["loss"][0])}
    for key in ("grads", "change"):
        med = statistics.median(ref[key][k] for k in kept)
        each = [abs(program[key][k] - ref[key][k]) / max(ref[key][k], med)
                for k in kept]
        name = key.rstrip("s")
        out[f"{name}_gap"] = max(each)
        out[f"{name}_median_gap"] = statistics.median(each)
    return out


def worst(program: dict, ref: dict) -> dict:
    """For each gap, the leaf (or step) that sets it, with both readings."""
    out = {}
    steps = [abs(a - b) / abs(b) for a, b in zip(program["loss"],
                                                 ref["loss"])]
    i = max(range(len(steps)), key=steps.__getitem__)
    out["loss_gap"] = (f"step {i + 1}", program["loss"][i], ref["loss"][i])
    med_g = statistics.median(ref["grads"].values())
    kept = [k for k, g in ref["grads"].items() if g >= 1e-3 * med_g]
    for key in ("grads", "change"):
        med = statistics.median(ref[key][k] for k in kept)
        k = max(kept, key=lambda k: abs(program[key][k] - ref[key][k])
                / max(ref[key][k], med))
        out[f"{key.rstrip('s')}_gap"] = (k, program[key][k], ref[key][k],
                                         med)
    return out


def compare(program: dict, ref: dict, limits: dict) -> dict:
    """The numbers the cell's limits file names, each beside its limit."""
    got = gaps(program, ref)
    return {k: {"value": got[k], "limit": v} for k, v in limits.items()}
