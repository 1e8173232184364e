"""A tiny-n rehearsal of each traffic mix on the CPU with the port's plain
kernels: the run reaches its comparison, is correct, and prints no device
metric.  The timed path itself refuses to run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import spec
from perfbench.tests.conftest import ROOT, tiny_cell

CELLS = ["flagship.rhs_stream", "hexkway.rhs_stream", "flagship.mc_samples"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cpu_rehearsal(name, trace, capsys):
    cell = tiny_cell(name)
    result = cells.run_cell(cell, 2 ** 31 + 17, 0.5, bool(trace),
                            time.perf_counter(), device="cpu")
    cells.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check answers_compared")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert result["device"] == {"platform": "cpu"}
    device_metrics = {m["name"] for m in spec.load_json(
        os.path.join(ROOT, "BENCHMARK.json"))["end_to_end"]
        + spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))["per_layer"]
        if m["source"] == "device_trace"}
    assert not device_metrics & set(result["metrics"])
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert result["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "flagship.rhs_stream", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_unknown_workload_fails():
    with pytest.raises(KeyError):
        spec.find_cell("nope.rhs_stream")
