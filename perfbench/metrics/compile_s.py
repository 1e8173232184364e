"""Seconds of a sample's ``compile_structured``, ending in a synchronise,
mean over the window's samples."""

import statistics


def read(run):
    if run.mix["loop"] != "mc_samples" or not run.records:
        return None
    return statistics.mean(r["compile_s"] for r in run.records)
