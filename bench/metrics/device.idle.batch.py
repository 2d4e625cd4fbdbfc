"""The share of the traced steps of the backlog in which no operation ran on
the device (1 - busy_s / window_s of the profiler's trace), in %."""
MOVES = "gen_tokens_per_s"


def read(run):
    if "decodes" not in run.values or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
