"""The trace reduction on a synthetic trace: busy union, span, idle share,
the idle gaps named by the host span open when each began."""

import pytest

from perfbench.harness.trace import merge, reduce_records


def test_merge_overlaps():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_reduce_synthetic_trace():
    kernels = [("lead", 0.0, 5.0),            # before the window: left out
               ("sweep", 100.0, 160.0),
               ("stencil", 150.0, 170.0),     # overlaps: busy 100..170
               ("sweep", 200.0, 260.0),
               ("copy", 300.0, 310.0)]
    spans = [("pcg.solve", 90.0, 265.0),
             ("answer.keep", 266.0, 290.0),
             ("rhs.next", 291.0, 299.0)]
    r = reduce_records(kernels, spans, (50.0, 400.0), wall_s=350e-6)
    assert r.busy_s == pytest.approx((70 + 60 + 10) * 1e-6)
    assert r.span_s == pytest.approx(210e-6)
    assert r.idle_pct == pytest.approx(100 * (1 - 140 / 210))
    assert r.window_s == 350e-6
    assert r.device_ops[0] == ["sweep", pytest.approx(120e-6)]
    assert [n for n, _ in r.device_ops] == ["sweep", "stencil", "copy"]
    # gap 170..200 begins inside pcg.solve; gap 260..300 begins there too
    assert r.idle_gaps == [["pcg.solve", pytest.approx(70e-6)]]


def test_gap_named_by_innermost_span_or_outside():
    kernels = [("k", 10.0, 20.0), ("k", 40.0, 50.0), ("k", 80.0, 90.0)]
    spans = [("outer", 0.0, 100.0), ("inner", 15.0, 30.0)]
    r = reduce_records(kernels, spans, (0.0, 100.0), wall_s=1e-4)
    assert dict((n, t) for n, t in r.idle_gaps) == {
        "inner": pytest.approx(20e-6), "outer": pytest.approx(30e-6)}
    r = reduce_records(kernels, [], (0.0, 100.0), wall_s=1e-4)
    assert r.idle_gaps == [["outside spans", pytest.approx(50e-6)]]


def test_no_device_work_raises():
    with pytest.raises(RuntimeError):
        reduce_records([("lead", 0.0, 1.0)], [], (5.0, 9.0), wall_s=1.0)


def test_span_annotations_on_the_device_are_not_work():
    kernels = [("pcg.solve", 10.0, 90.0), ("trace.window", 0.0, 100.0),
               ("k", 20.0, 30.0), ("k", 60.0, 70.0)]
    spans = [("pcg.solve", 10.0, 90.0)]
    r = reduce_records(kernels, spans, (0.0, 100.0), wall_s=1e-4)
    assert r.busy_s == pytest.approx(20e-6)
    assert r.device_ops == [["k", pytest.approx(20e-6)]]
