"""The control of the comparison that decides ``correct``, and readings of
the faults it has to catch; not part of a benchmark run.

    python3 perfbench/control.py --workload flagship.rhs_stream \
        --seeds 11,12,13 --seconds 5

For each seed, one process sets the cell up as a run does, drives a short
window at the cell's own load, and prints one JSON line with the worst
reading of each compared number over the kept answers for:

- ``program``: the answers as the timed path produced them;
- ``control``: the same answers rounded to bfloat16, the nearest precision
  below the float32 the configuration states for the PCG (a solve in
  bfloat16 returns its answer in bfloat16, so it reads at least this);
- ``unchanged``: the state left as it was (x = 0);
- ``altered``: each answer with one entry in 64 changed by 1 %;
- ``loose`` (``rhs_stream``): the kept loads solved again to a tolerance
  100 times looser, the error of a solve stopped early."""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def variants(run, torch) -> dict:
    """{variant: answers} from a run whose window has closed (program
    alive)."""
    answers = run.loop.answers()

    def mapped(fn):
        return [(s, f, fn(x)) for s, f, x in answers]

    def altered(x):
        y = x.clone()
        y[::64] *= 1.01
        return y

    out = {"program": answers,
           "control": mapped(lambda x: x.to(torch.bfloat16)),
           "unchanged": mapped(torch.zeros_like),
           "altered": mapped(altered)}
    loop = run.loop
    if run.mix["loop"] == "rhs_stream":
        tol = run.mix["rel_tol"] * 100
        loose = []
        for s, i in enumerate(loop.kept_ring):
            if i is not None:
                x, _ = loop.prog.solve(loop.ring[i], tol, run.mix["max_iter"])
                loose.append((loop.coef_seed, loop.sources[i], x))
        out["loose"] = loose
    return out


def readings_of(cell, seed, seconds, device="cuda") -> dict:
    import torch
    from perfbench.harness.cell import Run
    from perfbench.harness.correct import readings
    run = Run(cell, seed, device, torch)
    run.loop.setup()
    run.loop.window(seconds)
    out = {}
    for name, answers in variants(run, torch).items():
        nums = readings(run.ref, answers, run.problem, cell.limits,
                        device, torch)
        out[name] = {k: max(r[k] for r in nums) for k in nums[0]}
    out["requests"] = len(run.records)
    out["iterations"] = sorted({r["it"] for r in run.records})
    run.loop.free()
    del run
    gc.collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from perfbench.harness import spec
    cell = spec.find_cell(args.workload)
    if "host_threads" in cell.mix:
        from perfbench.harness.env import pin_threads
        pin_threads(cell.mix["host_threads"])
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings_of(cell, seed, args.seconds)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
