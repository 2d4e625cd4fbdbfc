"""Scenario on the PyTorch port: batched serving with prefill + greedy
decode on the zamba2 hybrid (SSM state + shared-attention KV cache both
flow through the decode step), on ``--device`` (CUDA by default).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke
from repro_torch.models import Model


def main(argv: list[str] | None = None) -> torch.Tensor:
    """Print the requests' first tokens; return every generated token
    (B, gen)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke("zamba2-2.7b")
    model = Model(cfg, device=args.device).init(
        torch.Generator(args.device).manual_seed(0))
    b, prompt, gen = 4, 24, 24
    toks = torch.randint(0, cfg.vocab, (b, prompt), device=model.device,
                         generator=torch.Generator(args.device).manual_seed(1))
    t0 = time.time()
    logits, cache = model.prefill({"tokens": toks}, pad_to=prompt + gen)
    tok = model.greedy(logits)[:, None]
    seqs = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(tok, cache)
        tok = model.greedy(logits)[:, None]
        seqs.append(tok)
    out = torch.cat(seqs, dim=1).cpu()
    dt = time.time() - t0
    print(f"served {b} requests: prompt {prompt} + {gen} generated "
          f"in {dt:.1f}s")
    for i in range(b):
        print(f"  req{i}: {out[i, :12].tolist()}...")
    return out


if __name__ == "__main__":
    main()
