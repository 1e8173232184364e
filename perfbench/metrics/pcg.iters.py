"""PCG iterations the solves of the window return, mean."""

import statistics


def read(run):
    if run.mix["loop"] != "rhs_stream" or not run.records:
        return None
    return statistics.mean(r["it"] for r in run.records)
