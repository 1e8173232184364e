"""One preconditioner application (the graphed V-cycle), median of 20
CUDA-event draws of 10 back-to-back calls."""

from perfbench.harness.timing import median_ms


def read(run):
    prog = getattr(run.loop, "prog", None)
    if prog is None or not run.on_card:
        return None
    b = run.loop.ring[0]
    return median_ms(lambda: prog.vcycle(b), run.torch)
