"""Seconds of a sample's ``api.flagship_problem`` outside the local
eigensolvers: the benchmark's span less ``setup.eig_s``, mean over the
window's samples."""

import statistics


def read(run):
    if run.mix["loop"] != "mc_samples" or not run.records:
        return None
    return statistics.mean(r["setup_s"] - r["eig_s"] for r in run.records)
