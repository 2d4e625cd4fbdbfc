"""The caching allocator's device allocations plus frees (``cudaMalloc``,
``cudaFree``) over the program's ``train.step`` span, per training step of
the window that the profiler did not trace."""
from harness import program

MOVES = "train_tokens_per_s"
program.record()


def read(run):
    return program.mean_attr(program.steps(run, "train.step"), "mallocs")
