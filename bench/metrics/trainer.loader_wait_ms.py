"""Host time blocked in ``next(loader)`` (the port's ``PrefetchingLoader``)
per step, over the window's steps that the profiler did not trace, in
ms."""
MOVES = "train_tokens_per_s"


def read(run):
    waits = [w for w, t in zip(run.values.get("loader_waits", ()),
                               run.values.get("traced", ())) if not t]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
