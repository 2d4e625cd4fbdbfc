"""Device idle time per traced decode step while the harness's thread was
inside the program's host range ``engine.decode``: the card waiting on the
host's launches, in ms."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    found = program.ranges(run, "engine.decode")
    if not found:
        return None
    return 1e3 * program.idle_inside(run, "engine.decode") / len(found)
