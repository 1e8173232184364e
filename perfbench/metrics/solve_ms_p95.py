"""95th percentile (nearest rank) of every solve of the window, each timed
by CUDA events from its call until its x is on the card."""

from perfbench.harness.stats import percentile


def read(run):
    if run.mix["loop"] != "rhs_stream" or not run.on_card:
        return None
    return percentile([r["solve_ms"] for r in run.records], 95)
