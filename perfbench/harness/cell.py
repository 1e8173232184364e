"""One run of one cell: set-up, the measured window, the metrics, the
comparison, the result line."""

from __future__ import annotations

import gc
import json
import subprocess
import sys

from perfbench.harness import spec as specs
from perfbench.harness.correct import judge, readings
from perfbench.harness.spans import Spans
from perfbench.harness.stats import quartiles
from perfbench.harness.traffic import LOOPS


class Run:
    """What a metric's reader (``read(run)``) can read: the cell, the
    window's records, the spans, the program while it lives, and the
    trace of the mix's traced stretch (made when first asked for).
    ``ref`` is the configuration's reference module, loaded once."""

    def __init__(self, cell: specs.Cell, seed: int, device, torch):
        self.cell, self.seed, self.device, self.torch = cell, seed, device, torch
        self.on_card = torch.device(device).type == "cuda"
        self.mix = cell.mix
        self.problem = cell.problem
        self.entry = specs.load_module("entries", cell.config["entry"])
        self.ref = specs.load_module("reference", cell.config["reference"])
        self.spans = Spans()
        self.loop = LOOPS[cell.mix["loop"]](self)
        self.setup_s = self.window_s = None
        self._trace = None

    @property
    def records(self) -> list:
        return self.loop.records

    def trace(self):
        if self._trace is None:
            self._trace = self.loop.traced()
        return self._trace


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def log(*parts):
    print("[perfbench]", *parts, file=sys.stderr, flush=True)


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda") -> dict:
    """The result of one run.  Off the card (``device="cpu"``, the CPU
    rehearsal) metrics read from the device are left out."""
    import torch
    if "host_threads" in cell.mix:
        torch.set_num_threads(cell.mix["host_threads"])
    run = Run(cell, seed, device, torch)
    run.loop.setup()
    t0, t1 = run.loop.window(seconds)
    run.setup_s, run.window_s = t0 - t_start, t1 - t0
    log(f"setup_s={run.setup_s:.3f} window_s={run.window_s:.3f} "
        f"requests={len(run.records)}")
    for key in ("solve_ms", "host_ms", "it", "setup_s", "compile_s",
                "solve_s", "eig_s"):
        vals = [r[key] for r in run.records if key in r]
        if len(vals) > 1:
            q1, q2, q3 = quartiles(vals)
            log(f"{key} min={min(vals):.4f} q1={q1:.4f} median={q2:.4f} "
                f"q3={q3:.4f} max={max(vals):.4f}")
    device_info = {"platform": "gpu" if run.on_card else "cpu"}
    if run.on_card:
        device_info.update(kind=torch.cuda.get_device_name(0), count=1,
                           memory_peak_bytes=torch.cuda.max_memory_allocated(0))
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        if m["source"] == "device_trace" and not run.on_card:
            continue
        value = specs.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": len(run.records),
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace and run.on_card:
        tr = run.trace()
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    if run.on_card:
        device_info["power"] = power_limit()
    not_converged = run.loop.failed()
    run.loop.free()
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    numbers = readings(run.ref, run.loop.answers(), run.problem,
                       cell.limits, device, torch)
    bad, checks = judge(numbers, cell.limits)
    result["failed"] = not_converged + bad
    result["correct"] = result["failed"] == 0 and len(numbers) > 0
    checks["not_converged"] = {"value": not_converged, "limit": 0}
    checks["answers_compared"] = {"value": len(numbers), "limit": 1}
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output (``checks`` its last key)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
