"""Device operations launched under the program's host range
``engine.decode`` per traced decode step: what bounds how far the host can
pace decode, and what a CUDA graph would cut."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    found = program.ranges(run, "engine.decode")
    if not found:
        return None
    return program.launches(run, "engine.decode") / len(found)
