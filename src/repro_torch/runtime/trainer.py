"""Training loop: one step per batch (or gradient accumulation over
microbatches), the synthetic corpus through the prefetching loader,
periodic checkpoints and crash-resume; a port of the reference's
``repro/runtime/trainer.py``.  Runs on the card unless ``device="cpu"``.

    state, losses = Trainer(cfg, TrainConfig(steps=50)).run()
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from .. import telemetry
from ..data import PrefetchingLoader, SyntheticCorpus
from ..launch.steps import make_train_step
from ..models import ArchConfig, Model
from ..optim import AdamW, AdamWConfig
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq_len: int = 128
    steps: int = 50
    microbatches: int = 1        # > 1: gradient accumulation
    ckpt_every: int = 0          # 0 = off
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    seed: int = 0


def make_accum_train_step(model: Model, opt: AdamW, n_micro: int):
    """Gradient accumulation over ``n_micro`` equal microbatches: each
    microbatch's gradients are added into f32 buffers, as the reference's
    f32 carry does (``repro/runtime/trainer.py:54-57``), and their mean
    takes one optimizer step.  The metric "loss" is the microbatches' mean.
    Its spans are ``make_train_step``'s, a forward and a backward for each
    microbatch (attribute ``micro``)."""
    def train_step(state, batch):
        with telemetry.span("train.step", allocator=model.device):
            params = state["params"]
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()}
            losses = []
            for p in params.values():
                p.grad = None
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                with telemetry.span("train.forward", device=model.device,
                                    micro=i):
                    loss, _ = model.train_loss(mb)
                with telemetry.span("train.backward", device=model.device,
                                    micro=i):
                    loss.backward()
                for n, p in params.items():
                    acc[n] += p.grad
                    p.grad = None
                losses.append(loss.detach())
            for g in acc.values():
                g /= n_micro
            with telemetry.span("train.optimizer", device=model.device):
                om = opt.update(acc, state["opt"], params)
            om["loss"] = torch.stack(losses).mean()
        return state, om

    return train_step


# what a batch of the families the loader cannot feed carries besides
# tokens and labels (B, S), as the reference's launch/input_specs.py::
# batch_specs lays it out
_NOT_TOKENS_ONLY = {"encdec": "frames (B, enc_len, d_model)",
                    "vlm": "patches (B, n_patches, 1024)"}


class Trainer:
    """``cfg`` trained on the synthetic corpus.  ``params`` (a flat state
    dict, e.g. from ``bridge.params_from_jax``) and ``opt_state`` start each
    run from copies of a given state instead of a draw from ``tcfg.seed``
    and zero moments.  ``metrics`` keeps each step's metrics as floats, and
    ``step_seconds`` each step's time on the host clock, from the call of
    the step function until its metrics are read (which waits for the
    device).

    The loader yields tokens and labels only, as the reference's does, so
    the encoder-decoder and the VLM, whose batches carry frames or patches
    besides, are refused: train them with ``launch.steps.make_train_step``
    on batches of the reference's ``launch/input_specs.py`` layout."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig,
                 opt_cfg: AdamWConfig | None = None, device="cuda",
                 params: dict | None = None,
                 opt_state: dict | None = None) -> None:
        if cfg.family in _NOT_TOKENS_ONLY:
            raise ValueError(
                f"{cfg.name}: Trainer's loader yields tokens and labels "
                f"only, and a {cfg.family} batch also carries "
                f"{_NOT_TOKENS_ONLY[cfg.family]}; train it with "
                f"launch/steps.make_train_step on batches laid out as "
                f"launch/input_specs.py::batch_specs lays them out")
        self.cfg = cfg
        self.tcfg = tcfg
        self.model = Model(cfg, device=device)
        self.device = self.model.device
        self._params, self._opt_state = params, opt_state
        self.opt = AdamW(opt_cfg or AdamWConfig(
            warmup_steps=max(tcfg.steps // 10, 1),
            total_steps=tcfg.steps))
        if tcfg.microbatches > 1:
            self.step_fn = make_accum_train_step(self.model, self.opt,
                                                 tcfg.microbatches)
        else:
            self.step_fn = make_train_step(self.model, self.opt)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_every else None)
        self.metrics: list[dict] = []
        self.step_seconds: list[float] = []

    def init_state(self) -> dict:
        if self._params is None:
            self.model.init(torch.Generator(self.device).manual_seed(
                self.tcfg.seed))
        else:     # a copy: the update is in place
            self.model.load_state({k: v.to(self.device, copy=True)
                                   for k, v in self._params.items()})
        params = dict(self.model.named_parameters())
        if self._opt_state is None:
            opt = self.opt.init(params)
        else:
            opt = _to(self._opt_state, self.device)
        return {"params": params, "opt": opt}

    def run(self, resume: bool = False):
        tcfg = self.tcfg
        state = self.init_state()
        start_step = 0
        if resume and self.ckpt is not None:
            try:
                state, start_step = self.ckpt.restore(state)
                start_step += 1
            except FileNotFoundError:
                pass
        corpus = SyntheticCorpus(self.cfg.vocab, tcfg.seq_len,
                                 seed=tcfg.seed)
        device = self.device
        loader = PrefetchingLoader(
            corpus, tcfg.batch, tcfg.seq_len,
            to_device=lambda x: torch.as_tensor(x, dtype=torch.int64).to(
                device),
            start_step=start_step)
        losses = []
        t0 = time.time()
        try:
            for step in range(start_step, tcfg.steps):
                batch = next(loader)
                t = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                self.step_seconds.append(time.perf_counter() - t)
                self.metrics.append(metrics)
                losses.append(metrics["loss"])
                if tcfg.log_every and step % tcfg.log_every == 0:
                    dt = time.time() - t0
                    print(f"step {step:5d} loss {metrics['loss']:8.4f} "
                          f"({dt:5.1f}s)", flush=True)
                if self.ckpt and (step + 1) % tcfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
        finally:
            loader.close()
        return state, losses


def _to(tree: dict, device) -> dict:
    """A copy of a nested dict of tensors on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}
