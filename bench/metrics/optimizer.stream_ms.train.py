"""Stream time of the program's ``train.optimizer`` span (``AdamW.update``),
between its CUDA events, per training step of the window that the profiler
did not trace, in ms: the untraced counterpart of ``optimizer.device_ms``,
which counts only the device's busy time in the traced steps."""
from harness import program

MOVES = "train_tokens_per_s"
program.record()


def read(run):
    return program.stream_ms(program.per_step(run, "train.step",
                                              "train.optimizer"))
