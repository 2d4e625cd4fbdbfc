"""The whole training step's share of the H100's peak: the frozen
``model_flops`` of the window's steps that the profiler did not trace
over their wall time at 989 TFLOP/s, in %."""
from harness.roofline import PEAK_FLOPS, model_flops

MOVES = "train_tokens_per_s"


def read(run):
    steps = [s for s, t in zip(run.values.get("train_steps", ()),
                               run.values.get("traced", ())) if not t]
    if not steps:
        return None
    flops = model_flops(run.arch, "train", run.values["batch"],
                        run.values["seq"]) * len(steps)
    return 100.0 * flops / (sum(e - a for a, e in steps) * PEAK_FLOPS)
