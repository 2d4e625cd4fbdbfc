"""Batched serving driver: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        [--smoke] [--batch 4 --prompt-len 32 --gen 16] [--device cuda]

Serves the dense, MoE and SSM families (``--arch arctic-480b`` or
``llama4-scout-17b-a16e``; the full MoE configs are larger than one 80 GB
card, so run those with ``--smoke``.  ``--arch mamba2-780m`` fits at its
full width and depth).  Runs on CUDA unless ``--device``
names another device.  Weights and prompt tokens are random, drawn from
seeded ``torch.Generator``s on that device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config, get_smoke
from ..models import Model
from ..models.common import require_device


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
    b, s = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab, (b, s), device=device,
                           generator=torch.Generator(device).manual_seed(1))

    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens}, pad_to=s + args.gen)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for _ in range(args.gen - 1):
        logits, cache = model.decode_step(tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    toks = torch.cat(out, dim=1).cpu()     # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} on {device} in {dt:.2f}s "
          f"({b * args.gen / dt:.1f} tok/s incl. first-call set-up)")
    print("sample:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
