"""End-to-end driver on the PyTorch port: train a small LM with the full
substrate stack -- WOW-prefetched data pipeline, AdamW, gradient
accumulation, checkpointing with crash-resume -- on ``--device`` (CUDA by
default).

Trains a ~10M-parameter deepseek-family model for a few hundred steps;
loss should drop by >1 nat.

    PYTHONPATH=src python examples/torch_train_wow_workflow.py \
        [--steps 200] [--device cpu]
"""
import argparse
import tempfile

import numpy as np

from repro_torch.models.config import ArchConfig
from repro_torch.runtime import TrainConfig, Trainer

CFG = ArchConfig(
    name="tiny-deepseek", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=1024, vocab=4096,
)


def main(argv: list[str] | None = None) -> list[float]:
    """Train, then resume from the last checkpoint; return the first
    run's losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = CFG.param_counts()["total"]
    print(f"model: {CFG.name}, {n / 1e6:.1f}M params")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        def trainer(log_every: int) -> Trainer:
            return Trainer(CFG, TrainConfig(
                batch=args.batch, seq_len=args.seq, steps=args.steps,
                microbatches=2, ckpt_every=max(args.steps // 4, 1),
                ckpt_dir=ckpt_dir, log_every=log_every), device=args.device)

        _, losses = trainer(max(args.steps // 10, 1)).run()
        print(f"\nloss: {np.mean(losses[:5]):.3f} -> "
              f"{np.mean(losses[-5:]):.3f} "
              f"(drop {np.mean(losses[:5]) - np.mean(losses[-5:]):.3f})")
        # crash-resume demo: restart from the last checkpoint
        _, resumed = trainer(0).run(resume=True)
        if resumed:
            print(f"resume from step {args.steps - len(resumed)}: "
                  f"{len(resumed)} steps re-run, final {resumed[-1]:.3f}")
        else:
            print("resume: checkpoint already at final step, nothing to do")
    return losses


if __name__ == "__main__":
    main()
