"""Run one cell of BENCHMARK.json once on one NVIDIA card.

    python3 perfbench/run.py --workload flagship.rhs_stream --seed 7 \
        --seconds 30 --trace 0

Prints the result as the last line of standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  Exits non-zero without a result when there is no card."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache at a fixed path inside the checkout
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    sys.path.insert(0, ROOT)
    from perfbench.harness import cell as cells
    from perfbench.harness import spec
    cell = spec.find_cell(args.workload)
    if "host_threads" in cell.mix:
        from perfbench.harness.env import pin_threads
        pin_threads(cell.mix["host_threads"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none or too few found", file=sys.stderr)
        return 3
    result = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            T_START)
    cells.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
