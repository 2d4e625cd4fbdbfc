"""The mean of the model's ``decode_step`` calls in the window that the
profiler did not trace, each timed on the host clock up to a
synchronize, in ms."""
MOVES = "gen_tokens_per_s"


def read(run):
    times = [d for e, d in run.values.get("decodes", ()) if run.untraced(e)]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
