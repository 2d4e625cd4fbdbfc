"""Batched serving driver: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        [--smoke] [--batch 4 --prompt-len 32 --gen 16] [--device cuda]

Serves every family.  At full width one 80 GB card holds deepseek-7b,
mamba2-780m, zamba2-2.7b (hybrid), whisper-medium (encoder-decoder: 1500
audio frames) and llava-next-mistral-7b (VLM: 2880 image patches before the
prompt); the full MoE configs (``--arch arctic-480b`` or
``llama4-scout-17b-a16e``) are larger than the card, so run those with
``--smoke``.  The encoder-decoder and the VLM are served here and not by
``runtime.ServingEngine``, whose requests are token prompts alone.  Runs on
CUDA unless ``--device`` names another device.  Weights, prompt tokens,
frames and patches are random, drawn from seeded ``torch.Generator``s on
that device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config, get_smoke
from ..models import Model
from ..models.common import require_device
from ..models.config import ArchConfig
from ..models.lm import PATCH_DIM


def make_batch(cfg: ArchConfig, b: int, s: int, device) -> dict:
    """Random prompt tokens (B,S) and, for the encoder-decoder, frames
    (B, enc_len, d_model), for the VLM patches (B, n_patches, 1024), each
    0.1 N(0, 1), drawn from generators seeded 1 on ``device``."""
    gen = torch.Generator(device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device=device,
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(
            (b, cfg.enc_len, cfg.d_model), device=device, generator=gen)
    if cfg.family == "vlm":
        batch["patches"] = 0.1 * torch.randn(
            (b, cfg.n_patches, PATCH_DIM), device=device, generator=gen)
    return batch


def pad_len(cfg: ArchConfig, s: int, gen: int) -> int:
    """The K/V length a prompt of ``s`` tokens and ``gen`` new ones need:
    the VLM's patches come first."""
    return s + gen + (cfg.n_patches if cfg.family == "vlm" else 0)


def generate(model: Model, batch: dict, gen: int) -> torch.Tensor:
    """Prefill the batch, then ``gen - 1`` greedy decode steps; (B, gen)
    tokens on the model's device.  On a mesh the prefill's cache is cut to
    the rank's kv heads (``Model.own_heads``: an "fsdp" prefill hands over
    every head)."""
    pad_to = pad_len(model.cfg, batch["tokens"].shape[1], gen)
    logits, cache = model.prefill(batch, pad_to=pad_to)
    cache = model.own_heads(cache)
    tok = model.greedy(logits)[:, None]
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(tok, cache)
        tok = model.greedy(logits)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=device).init(
        torch.Generator(device).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt_len, device)

    t0 = time.perf_counter()
    toks = generate(model, batch, args.gen).cpu()     # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s incl. first-call "
          f"set-up)")
    print("sample:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
