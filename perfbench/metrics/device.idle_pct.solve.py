"""Idle share of the device over a traced stretch of solves: 100 (1 - busy
/ span), busy the union of the device intervals."""


def read(run):
    if run.mix["loop"] != "rhs_stream" or not run.on_card:
        return None
    return run.trace().idle_pct
