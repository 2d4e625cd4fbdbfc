"""Stream time of the program's ``engine.decode`` span (the decode step and
its greedy tokens), between its CUDA events, per decode step of the engine
steps of the window that the profiler did not trace, in ms: the program's
counterpart of ``model.decode_step_ms.batch``, which adds no synchronize of
its own (the harness's timing of ``decode_step`` in a traced run puts one
inside the span)."""
from harness import program

MOVES = "gen_tokens_per_s"
program.record()


def read(run):
    decodes = [[s] for found in program.per_step(run, "engine.step",
                                                 "engine.decode")
               for s in found]
    return program.stream_ms(decodes)
