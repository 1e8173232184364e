"""Percentiles, quartiles and window arithmetic."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]


def quartiles(values) -> tuple:
    """(Q1, median, Q3) as ``statistics.quantiles(values, n=4)`` gives
    them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3


def per_item(window_s: float, count: int) -> float:
    """The window's whole length over the items completed in it."""
    if count <= 0:
        raise ValueError("no item completed in the window")
    return window_s / count
