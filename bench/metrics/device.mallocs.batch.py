"""The caching allocator's device allocations plus frees (``cudaMalloc``,
``cudaFree``) over the program's ``engine.step`` span, per engine step of
the window that the profiler did not trace."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    return program.mean_attr(program.steps(run, "engine.step"), "mallocs")
