"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control 1,2,3 [--seconds S] [--out FILE]

For each of ``--seeds`` it runs the cell once in this process (set-up, a
window of ``--seconds``, the check) and keeps the numbers compared: the
program's readings, whose largest is a limit's lower reading.  For each of
``--control`` it reads the control, the reference computed with float8
products in the program's place, on the same run's inputs: the training
gaps of the control's first steps from the float32 reference's, or the
served tokens' gaps of the tokens the control puts first; and, for a
training cell, the gaps of a planted fault, the loss taken over half of
the batch.  A step that returns its state unchanged reads a change gap of
1 by the measure and needs no run.  Every reading goes to standard output
and, as JSON, to ``--out``.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

from harness import serve, train  # noqa: E402
from harness.cell import run  # noqa: E402
from harness.common import require_cards  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda":
        require_cards(1)
    control = {int(s) for s in a.control.split(",") if s}
    out = {"program": {}, "control": {}, "half_batch": {}}
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        line, ctx = run(args, time.perf_counter(), device=a.device)
        out["program"][seed] = (
            train.gaps(ctx.values["program"], ctx.values["reference"])
            if "reference" in ctx.values else
            {k: c["value"] for k, c in ctx.checks.items()})
        print(f"program seed {seed}: {out['program'][seed]} "
              f"{line['metrics']} {ctx.end_to_end}", flush=True)
        if "reference" in ctx.values:
            print(f"  set by: {train.worst(ctx.values['program'], ctx.values['reference'])}",
                  flush=True)
        if seed not in control:
            continue
        v = ctx.values
        if "reference" in v:
            tr = ctx.traffic
            shape = (tr["batch"], tr["seq_len"], tr["checked_steps"])
            with tempfile.TemporaryDirectory() as tmp:
                path = train.write_tokens(tmp, seed, ctx.arch.vocab,
                                          tr["batch"], tr["seq_len"],
                                          tr["file_steps"])
                for key, kw in (("control", {"precision": "fp8"}),
                                ("half_batch", {"half_batch": True})):
                    got = train.reference_steps(ctx.config, ctx.arch, seed,
                                                path, *shape, ctx.device,
                                                **kw)
                    out[key][seed] = train.gaps(got, v["reference"])
                    print(f"{key} seed {seed}: {out[key][seed]}",
                          flush=True)
        else:
            gap = serve.served_gap(ctx.arch, seed, v["checked"], ctx.device,
                                   "fp8", control=True)
            out["control"][seed] = {"logit_gap": gap}
            print(f"control seed {seed}: {out['control'][seed]}", flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
