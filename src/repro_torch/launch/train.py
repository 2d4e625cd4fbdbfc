"""Training driver.

    python -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --device cpu --steps 50 --batch 8 --seq 128

Runs on the card unless ``--device cpu``.  The same flags as the
reference's ``repro/launch/train.py``, plus ``--device``.  It trains the
token-only families; ``Trainer`` refuses whisper-medium and
llava-next-mistral-7b, whose batches carry frames or patches: train those
with ``launch/steps.make_train_step``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ARCHS, get_config, get_smoke
from ..runtime import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(batch=args.batch, seq_len=args.seq, steps=args.steps,
                       microbatches=args.microbatches,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tcfg, device=args.device)
    _, losses = trainer.run(resume=args.resume)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
