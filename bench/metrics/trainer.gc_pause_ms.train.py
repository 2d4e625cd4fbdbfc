"""Host time in garbage collections (the program's ``gc`` spans, in any
thread) in the window outside the traced stretch, per training step there,
in ms."""
from harness import program

MOVES = "train_tokens_per_s"
program.record()


def read(run):
    tops = program.steps(run, "train.step")
    if not tops:
        return None
    return 1e3 * program.untraced_gc_seconds(run) / len(tops)
