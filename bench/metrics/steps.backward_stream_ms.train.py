"""Stream time of the program's ``train.backward`` span (``loss.backward()``,
remat's recompute included), between its CUDA events, per training step of
the window that the profiler did not trace, in ms."""
from harness import program

MOVES = "train_tokens_per_s"
program.record()


def read(run):
    return program.stream_ms(program.per_step(run, "train.step",
                                              "train.backward"))
