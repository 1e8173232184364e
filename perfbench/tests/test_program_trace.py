"""The reduction of the program's spans and events on synthetic records
(harness/program_trace.py): replays grouped by correlation id, idle time
inside a replay against idle time between launches named by the
program's innermost range, and the pairing of (b)'s busy time with (a)'s
event lengths."""

import dataclasses

import pytest

from perfbench.harness.program_trace import (OUTSIDE, ProgramTrace, _log,
                                             _paired, graph_idle_pct,
                                             group_replays, kernel_counts,
                                             launch_gaps_us, split_idle)

# one solve: the prologue (correlation id 7) and two bodies (8, 9)
RANGES = [("pcg.prologue", 0.0, 12.0), ("pcg.loop", 12.0, 100.0),
          ("pcg.flag_wait", 20.0, 30.0), ("pcg.launch", 30.0, 36.0),
          ("pcg.flag_wait", 60.0, 70.0), ("pcg.launch", 72.0, 76.0)]
LAUNCHES = [(7, 5.0), (8, 31.0), (9, 73.0)]
DEVICE = [(7, 10.0, 15.0),
          (8, 40.0, 45.0), (8, 47.0, 50.0), (8, 49.0, 52.0),
          (9, 80.0, 85.0), (9, 86.0, 90.0), (9, 89.0, 92.0),
          (3, 0.0, 1.0)]                      # a record of no launch


def _solves():
    return group_replays(DEVICE, LAUNCHES, RANGES)


def test_replays_grouped_by_correlation_id():
    (solve,) = _solves()
    assert [(r.name, r.kernels) for r in solve] == [
        ("prologue", 1), ("body", 3), ("body", 3)]
    assert [(r.busy_ns, r.start_ns, r.end_ns) for r in solve] == [
        (5.0, 10.0, 15.0), (10.0, 40.0, 52.0), (11.0, 80.0, 92.0)]


def test_gap_inside_one_correlation_id_is_inside_the_graph():
    inside, between = split_idle(_solves(), RANGES)
    # 45..47 in replay 8, 85..86 in replay 9
    assert inside == pytest.approx(3.0)
    assert sum(between.values()) == pytest.approx((40 - 15) + (80 - 52))


def test_gap_between_launches_named_by_innermost_range():
    _, between = split_idle(_solves(), RANGES)
    # 15..40: loop 15..20, flag wait 20..30, launch 30..36, loop 36..40;
    # 52..80: loop 52..60 and 70..72 and 76..80, flag wait 60..70,
    # launch 72..76
    assert between == {"pcg.loop": pytest.approx(5 + 4 + 8 + 2 + 4),
                       "pcg.flag_wait": pytest.approx(20.0),
                       "pcg.launch": pytest.approx(10.0)}
    _, between = split_idle(_solves(), [])
    assert between == {OUTSIDE: pytest.approx(53.0)}


def test_launches_before_a_prologue_and_replays_without_records_left_out():
    solves = group_replays(DEVICE, [(1, -5.0), (2, 55.0)] + LAUNCHES, RANGES)
    assert [[r.name for r in s] for s in solves] == [
        ["prologue", "body", "body"]]


def test_graph_idle_pairs_busy_of_b_with_event_lengths_of_a():
    timeline = [("prologue", 0.0, 0.010), ("body", 0.040, 0.052),
                ("body", 0.080, 0.100)]
    assert launch_gaps_us(timeline) == pytest.approx([30.0, 28.0])
    pt = ProgramTrace([timeline], _solves(), 0.0, {}, 0.0)
    # busy 10 and 11 ns against event lengths 12 and 20 us: medians
    # 10.5 ns and 16 us
    assert pt.graph_idle_pct == pytest.approx(
        100 * (1 - 10.5e-6 / 0.016))
    assert graph_idle_pct([10.0, 11.0], [10.5e-6, 10.5e-6]) == \
        pytest.approx(0.0)
    assert pt.launch_gap_us == pytest.approx(29.0)


def test_solves_with_lost_records_or_other_launches_left_out():
    """A replay with fewer kernels than its graph has lost records to the
    profiler, and a solve with other launches than (a)'s is another
    solve: both are left out of the pairing."""
    (solve,) = _solves()
    lossy = solve[:2] + [dataclasses.replace(solve[2], kernels=2)]
    timeline = [("prologue", 0.0, 0.010), ("body", 0.040, 0.052),
                ("body", 0.080, 0.100)]
    assert _paired([solve, lossy, solve, solve[:2]], [timeline] * 4) == \
        [0, 2]


def test_log_shows_every_window_before_pairing(capsys):
    """The log gives each profiler window's kernel counts over every
    replay, so a replay that lost records shows even where its solve is
    left out, and says whether the iteration counts agree."""
    (solve,) = _solves()
    lossy = solve[:2] + [dataclasses.replace(solve[2], kernels=2)]
    assert kernel_counts([solve, lossy]) == {"prologue:1": 2, "body:3": 3,
                                             "body:2": 1}
    timeline = [("prologue", 0.0, 0.010), ("body", 0.040, 0.052),
                ("body", 0.080, 0.100)]
    inside, between = split_idle([solve], RANGES)
    pt = ProgramTrace([timeline], [solve], inside, between, 26.0)
    _log(pt, 2, [(kernel_counts([solve, lossy]), 1)], {
        "pcg.iterations": 2, "returned": 2, "launched": 3,
        "body_back_to_back_ms": 1.1e-5, "profiler_windows": 1})
    err = capsys.readouterr().err
    assert "window 1: replay_kernels={'prologue:1': 2, 'body:3': 3, " \
        "'body:2': 1} (every replay) solves kept=1/2" in err
    assert "solves=1/2 replay_kernels={'prologue:1': 1, 'body:3': 2}" in err
    assert "body launches=3 (DISAGREE)" in err
    assert "profiler_windows=1" in err
