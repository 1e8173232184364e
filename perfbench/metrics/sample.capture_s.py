"""Seconds of CUDA graph capture a Monte Carlo sample: the program's
phase ``graph.capture`` (utils/logging.TIMERS: warm-up and capture of
the PCG prologue and body, and of any V-cycle graph) over the calls of
its phase ``compile``, one a sample; both totals run over the same
samples (warm-up, window and traced)."""

from perfbench.harness.cell import log


def read(run):
    if run.mix["loop"] != "mc_samples":
        return None
    from saamge_tpu_torch.utils.logging import TIMERS
    samples = TIMERS.counts.get("compile", 0)
    if not hasattr(TIMERS, "counters") or samples == 0:
        return None
    per = {k: v / samples for k, v in sorted(TIMERS.totals.items())
           if k.startswith(("compile", "graph."))}
    log(f"sample samples={samples} seconds a sample: {per!r} "
        f"graph.captures={TIMERS.counters.get('graph.captures', 0)} "
        f"graph.remade={TIMERS.counters.get('graph.remade', 0)}")
    return TIMERS.total("graph.capture") / samples
