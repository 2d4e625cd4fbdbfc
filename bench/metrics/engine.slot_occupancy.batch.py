"""The engine's ``utilization`` (active slots over slots) averaged over
the window's decode steps, in %."""
MOVES = "gen_tokens_per_s"


def read(run):
    occ = [f for _, f in run.values.get("occupancy", ())]
    if not occ:
        return None
    return 100.0 * sum(occ) / len(occ)
