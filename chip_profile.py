#!/usr/bin/env python3
"""Device-time profile of the port's solve paths on one NVIDIA card.

    python3 chip_profile.py                     # all four paths
    python3 chip_profile.py --paths general     # one path

For each path (flagship, capacity, contract: the n=96 structured
hierarchies of chip_smoke.py; general: hexkway n=64) one warm-up PCG
solve at 1e-6, then one PCG solve at 1e-6 under ``torch.profiler``.
Prints per path the wall time of the traced solve, the device busy time
(the union of the kernel intervals), the span from the first kernel's
start to the last one's end, the idle share 1 - busy / span, the kernel
launches per PCG iteration (one V-cycle and one operator matvec, plus
the PCG's vector updates), and the device time per kernel name (calls,
total, mean), largest first; writes
the same as JSON to ``chiprun_out/profile_<path>.json``.  Exits non-zero
without a card."""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

PATHS = ("flagship", "capacity", "contract", "general")


def device_profile(prof, torch):
    """(busy us, span us, {kernel name: [calls, total us]}) of the CUDA
    kernels in a finished profile."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    iv = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (iv[-1][1] - iv[0][0]) if iv else 0.0
    by_name = {}
    for e in kern:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    return busy, span, by_name


def profile_path(name, h, solve, b, torch, out_dir):
    from torch.profiler import ProfilerActivity, profile
    solve(h, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, it, _ = solve(h, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, span, by_name = device_profile(prof, torch)
    kernels = sorted(({"name": k, "calls": c, "total_us": t,
                       "mean_us": t / c} for k, (c, t) in by_name.items()),
                     key=lambda r: -r["total_us"])
    launches = sum(c for c, _ in by_name.values())
    rec = {"path": name, "pcg_iters": it, "wall_ms": wall * 1e3,
           "device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
           "idle_share": 1.0 - busy / span if span else None,
           "launches": launches, "launches_per_iter": launches / max(it, 1),
           "kernels": kernels}
    print(f"[{name}] pcg_iters={it} wall_ms={wall * 1e3:.3f} "
          f"device_busy_ms={busy / 1e3:.3f} span_ms={span / 1e3:.3f} "
          f"idle_share={rec['idle_share']:.4f} launches={launches} "
          f"launches_per_iter={rec['launches_per_iter']:.1f}", flush=True)
    for k in kernels[:15]:
        print(f"  {k['total_us']:10.1f} us  {k['calls']:5d} calls  "
              f"{k['mean_us']:8.2f} us/call  {k['name'][:90]}")
    with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--general-n", type=int, default=64)
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"paths must be among {PATHS}")

    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from saamge_tpu_torch import (compile_hierarchy, compile_structured,
                                  flagship_problem, general_problem,
                                  pcg_solve, struct_pcg_solve)
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    print("[device]", torch.cuda.get_device_name(0), torch.__version__,
          flush=True)

    def s_solve(h, b):
        return struct_pcg_solve(h, b, rel_tol=1e-6)

    def g_solve(h, b):
        return pcg_solve(h, b, rel_tol=1e-6, max_iter=300)

    if {"flagship", "capacity", "contract"} & set(paths):
        ml, b, geo, supers, fac = flagship_problem(n=args.n, mfree=True)
        kw = {"flagship": {},
              "capacity": {"mfree": fac, "hbm_frugal": True,
                           "ainv_dtype": torch.bfloat16},
              "contract": {"rp_dtype": torch.float32,
                           "use_pallas_contract": True}}
        cpu = {p: compile_structured(ml, geo, supers, device="cpu", **kw[p])
               for p in kw if p in paths}
        del ml
        bd = torch.as_tensor(b, dtype=torch.float32, device=dev)
        for p, h_cpu in cpu.items():
            h = copy.deepcopy(h_cpu).to(dev)
            profile_path(p, h, s_solve, bd, torch, out_dir)
            del h
            torch.cuda.empty_cache()
    if "general" in paths:
        ml, _, b = general_problem(n=args.general_n)
        h = compile_hierarchy(ml, torch.float32, device=dev)
        del ml
        bd = torch.as_tensor(b, dtype=torch.float32, device=dev)
        profile_path("general", h, g_solve, bd, torch, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
