"""Device time of the kernels that the optimizer's ``update`` call
(wrapped on the instance as ``bench:opt.update``) runs, per traced
training step, in ms: the device operations inside the range's spans on
the device timeline, each counted once (the update runs alone on the
stream, after the backward has finished)."""
MOVES = "train_tokens_per_s"


def read(run):
    if "train_steps" not in run.values or not run.traced:
        return None
    secs = run.trace.within("bench:opt.update")
    if secs <= 0:
        raise RuntimeError("no device time in the optimizer's update")
    return 1e3 * secs / run.traced
