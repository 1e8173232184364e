"""The least time one fine smoothing chain of the elasticity cell (its
roots and the trailing residual) needs on the card, from the problem's
shapes (harness/roofline_elasticity.py), over its measured time (CUDA
events around the port's fine smoothing call at the hierarchy's own
operands), in %."""

from perfbench.harness.cell import log
from perfbench.harness.roofline import least_time_s
from perfbench.harness.roofline_elasticity import elasticity_smooth_work
from perfbench.harness.timing import median_ms


def read(run):
    prog = getattr(run.loop, "prog", None)
    if prog is None or not run.on_card:
        return None
    b = run.loop.ring[0]
    ms = median_ms(lambda: prog.fine_smooth(b), run.torch)
    nbytes, ops = elasticity_smooth_work(run.problem["n"], prog.fine_dtype,
                                         prog.fine_roots)
    least, bound = least_time_s(nbytes, ops)
    log(f"elasticity fine_smooth measured_ms={ms!r} "
        f"least_ms={least * 1e3!r} bound={bound} bytes={nbytes} ops={ops} "
        f"roots={prog.fine_roots}")
    return 100.0 * least / (ms / 1e3)
