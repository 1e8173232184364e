"""The window's whole length over the solves completed in it (host clock)."""

from perfbench.harness.stats import per_item


def read(run):
    if run.mix["loop"] != "rhs_stream":
        return None
    return per_item(run.window_s, len(run.records)) * 1e3
