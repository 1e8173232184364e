"""Seconds a sample's setup spends in the local eigensolvers, by the
program's timers (``setup.device_pipeline`` + ``setup.local_eigensolves``),
mean over the window's samples."""

import statistics


def read(run):
    if run.mix["loop"] != "mc_samples" or not run.records:
        return None
    return statistics.mean(r["eig_s"] for r in run.records)
