"""Idle share of the device over one traced sample: 100 (1 - busy / span),
busy the union of the device intervals."""


def read(run):
    if run.mix["loop"] != "mc_samples" or not run.on_card:
        return None
    return run.trace().idle_pct
