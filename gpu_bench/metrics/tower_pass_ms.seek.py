"""Mean host time of one batched tower pass (it ends in the readback, so the
device's time is in it): the program's ``queue.pass`` spans inside the
measured window, those overlapping the profiler's start and stop left out.
The program's own counterpart of ``text_pass_ms.seek``."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.mean_ms(r, "queue.pass")
