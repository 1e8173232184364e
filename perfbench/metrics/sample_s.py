"""The window's whole length over the Monte Carlo samples completed in it
(host clock)."""

from perfbench.harness.stats import per_item


def read(run):
    if run.mix["loop"] != "mc_samples":
        return None
    return per_item(run.window_s, len(run.records))
