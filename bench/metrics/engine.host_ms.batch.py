"""Per engine step of the window that the profiler did not trace, the
program's ``engine.step`` span less its ``engine.decode`` and ``engine.read``
spans: the host's own work around the decode call (admission's launches,
the splice, the tokens' bookkeeping, retirement), in ms.  The decode span
is left out because a traced run times each ``decode_step`` to a
synchronize inside it, so its host time there is the device's."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    tops = program.steps(run, "engine.step")
    if not tops:
        return None
    own = [top.seconds - sum(s.seconds for name in ("engine.decode",
                                                    "engine.read")
                             for s in program.within(run, top, name))
           for top in tops]
    return 1e3 * sum(own) / len(own)
