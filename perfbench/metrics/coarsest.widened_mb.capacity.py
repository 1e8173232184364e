"""MB of the f32 copies that one eager V-cycle (``graph=False``) makes of
the coarsest inverse, and of a dense R1 (the program's counter
``coarsest.widened_bytes``, utils/logging.TIMERS); the launch counters of
the capacity kernels and their plain routes over the run go to the log."""

from perfbench.harness.cell import log

KEY = "coarsest.widened_bytes"
ROUTES = ("mfree.kernel", "mfree.plain", "midmv.kernel", "midmv.plain")


def read(run):
    prog = getattr(run.loop, "prog", None)
    if prog is None:
        return None
    from saamge_tpu_torch import struct_vcycle_apply
    from saamge_tpu_torch.utils.logging import TIMERS
    counters, h = TIMERS.counters, prog.h
    log("capacity routes " + " ".join(
        f"{k}={counters.get(k)!r}" for k in ROUTES)
        + f" Ainv={tuple(h.Ainv.shape)} {h.Ainv.dtype}"
        + f" Rst1={tuple(h.Rst1.shape)} {h.Rst1.dtype}")
    before = counters.get(KEY)
    struct_vcycle_apply(h, run.loop.ring[0], graph=False)
    if KEY not in counters:
        return None
    return (counters[KEY] - (before or 0)) / 1e6
