"""The full-capacity cell (``capacity.rhs_stream``) rehearsed on the CPU at
n=16 (4^3-element bricks, superbricks (2, 2, 2)) with the port's plain
kernels, and the work counts of its rooflines (harness/roofline_mfree.py)
against hand counts."""

import dataclasses
import json
import time

import pytest

import saamge_tpu_torch  # noqa: F401  (its log stream: stdout before capsys)
from perfbench.harness import cell as cells
from perfbench.harness import spec
from perfbench.harness.roofline import q1_nnz
from perfbench.harness.roofline_mfree import mid_pass_work, mfree_smooth_work

NAME = "capacity.rhs_stream"
TINY = {"n": 16, "brick": 4, "super_bricks": [2, 2, 2]}


def tiny_capacity():
    c = spec.find_cell(NAME)
    return dataclasses.replace(c, config={**c.config, **TINY},
                               limits={**c.limits, "check_block": 4})


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal(trace, capsys):
    cell = tiny_capacity()
    result = cells.run_cell(cell, 2 ** 31 + 23, 0.5, bool(trace),
                            time.perf_counter(), device="cpu")
    cells.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert result["device"] == {"platform": "cpu"}
    names = set(result["metrics"])
    if trace:
        # the device's metrics are left out off the card; the counters
        # are read: one f32 copy of the bf16 coarsest inverse a V-cycle
        assert names == {"pcg.iters.capacity", "coarsest.widened_mb.capacity"}
        assert result["metrics"]["coarsest.widened_mb.capacity"]["value"] > 0
        assert "capacity routes mfree.kernel=None mfree.plain=" in err
    else:
        assert names == {"solve_ms", "setup_s"}


def test_the_cell_reports_its_metrics():
    cell = spec.find_cell(NAME)
    assert cell.config["entry"] == "capacity" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "solve_ms", "solve_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "pcg.iters.capacity", "vcycle_ms.capacity",
        "capacity_fine_smooth_roofline", "capacity_mid_roofline",
        "coarsest.widened_mb.capacity"}
    assert cell.config["n"] // cell.config["brick"] == 24
    assert cell.config["super_bricks"] == [6, 6, 6]
    assert cell.limits["check_block"] == cell.config["n"] // 4


def test_mfree_smooth_work_by_hand():
    # n = 2: 8 elements, 27 nodes, 27 nonzeros (q1_nnz); 10 roots + the
    # residual; bf16 coefficients
    assert q1_nnz(2) == 27
    nbytes, ops = mfree_smooth_work(2, "bfloat16", 10)
    assert nbytes == 8 * 2 + 4 * 27 * 4
    assert ops == 2 * 27 * 11
    nbytes, ops = mfree_smooth_work(2, "float32", 3)
    assert nbytes == 8 * 4 + 4 * 27 * 4
    assert ops == 2 * 27 * 4


def test_mid_pass_work_by_hand():
    nbytes, ops = mid_pass_work(100, 10, "bfloat16")
    assert nbytes == 100 * 2 + 4 * 10 * 4 and ops == 200
