"""Percentile and window arithmetic."""

import statistics

import pytest

from perfbench.harness.stats import per_item, percentile, quartiles


def test_percentile_nearest_rank():
    v = list(range(1, 101))          # 1..100
    assert percentile(v, 95) == 95
    assert percentile(v, 100) == 100
    assert percentile([7.0], 95) == 7.0
    assert percentile([3, 1, 2], 50) == 2
    # 20 values: the 95th percentile is the 19th smallest
    assert percentile(list(range(20)), 95) == 18
    with pytest.raises(ValueError):
        percentile([], 95)


def test_quartiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = quartiles(v)
    assert (q1, q2, q3) == tuple(statistics.quantiles(v, n=4))
    assert q2 == 12.5


def test_window_over_items():
    assert per_item(10.0, 400) == 0.025
    with pytest.raises(ValueError):
        per_item(10.0, 0)
