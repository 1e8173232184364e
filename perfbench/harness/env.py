"""The process's host threads, pinned before numpy and torch load."""

from __future__ import annotations

import os

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def pin_threads(n: int) -> None:
    for var in THREAD_VARS:
        os.environ[var] = str(n)
