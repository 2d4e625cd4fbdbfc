"""The serving window's share of the H100's peak: the frozen
``model_flops`` of every prefill and decode token served in the window
outside the traced stretch (each decode token at the positions it attends
to) over that part of the window at 989 TFLOP/s, in %."""
from harness.roofline import PEAK_FLOPS, model_flops

MOVES = "gen_tokens_per_s"


def read(run):
    work = [(k, n) for t, k, n in run.values.get("work", ())
            if run.untraced(t)]
    if not work:
        return None
    flops = sum(model_flops(run.arch, kind, 1, n) for kind, n in work)
    secs = run.untraced_seconds(*run.values["window"])
    return 100.0 * flops / (secs * PEAK_FLOPS)
