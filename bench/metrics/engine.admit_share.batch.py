"""The program's ``engine.admit`` spans (a request's prefill, splice and first
token's read) over its ``engine.step`` spans, host time, in the engine steps
of the window that the profiler did not trace, in %."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    tops = program.steps(run, "engine.step")
    if not tops:
        return None
    admit = sum(s.seconds for top in tops
                for s in program.within(run, top, "engine.admit"))
    return 100.0 * admit / sum(s.seconds for s in tops)
