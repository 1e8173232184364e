#!/usr/bin/env python3
"""Device-time profile of the port's solve paths on one NVIDIA card.

    python3 chip_profile.py                     # all seven paths
    python3 chip_profile.py --paths general     # one path
    python3 chip_profile.py --paths scale --scale-n 200   # 8.12M dofs

For each path (flagship, capacity, contract, twolevel: the n=96
structured hierarchies of chip_smoke.py, the two-level one compiled on
the card; general: hexkway n=64; scale: the hierarchy of the scale-setup
driver, saamge_tpu_torch/drivers/run_scale_setup.py, with the device
RAP, at n=128 by default; sharded: the flagship hierarchy split over 4
shards of the card, parallel/structured_sharded.py, as ``sharded4``)
and each PCG loop
(``eager``: ``graph=False``, every kernel launched from Python and the
stopping test read each iteration; ``graph``: the default, the prologue
and each iteration replayed as captured CUDA graphs) one warm-up PCG
solve at 1e-6 (for the graph loop, the capture), then one PCG solve at
1e-6 under ``torch.profiler``.  Prints per path and loop the wall time
of the traced solve, the device busy time (the union of the kernel
intervals), the span from the first kernel's start to the last one's
end, the idle share 1 - busy / span, the exchange share (device time of
same-dtype device copies and concatenations over busy: on the sharded
path its halo fills and exchanges, with the PCG's few state copies),
the device kernel records per PCG
iteration, the host's kernel launches and graph launches per iteration
(the runtime calls in the trace), and the device time per kernel name
(calls, total, mean), largest first.  For the graph loop also: the
median untraced wall time of the solve, the device time of one
prologue and of one iteration (their graphs replayed back to back,
CUDA events), and from them the host gap per iteration (wall minus the
prologue, over the iterations, minus one iteration's device time: the
event wait, the flag's read and the graph launch).  Peak device bytes
(allocated and reserved) of an untraced 1e-6 solve of each loop.
Writes the same as JSON to ``chiprun_out/profile_<path>.json``.  Exits
non-zero without a card."""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

from perfbench.harness.timing import host_gap_us, replay_ms

PATHS = ("flagship", "capacity", "contract", "general", "twolevel", "scale",
         "sharded")
# the device records of the sharded path's halo fills and exchanges:
# same-dtype copies (a halo plane, P's first plane) and concatenations
# (the all-gathers, the mid's brick layers)
EXCHANGE_KERNELS = ("Memcpy DtoD", "CatArrayBatchedCopy")


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


def host_launches(prof, torch):
    """(kernel launches, graph launches) the host made in a finished
    profile: its ``cudaLaunch*`` / ``cuLaunch*`` and graph launch
    calls."""
    kernels = graphs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch")):
            graphs += 1
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            kernels += 1
    return kernels, graphs


def trace_solve(solve, h, b, torch):
    """One warm-up solve, then one traced solve: a record of its device
    time, idle share and launches."""
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
    exchange_us = sum(t for k, (_, t) in by_name.items()
                      if any(w in k for w in EXCHANGE_KERNELS))
    host_k, host_g = host_launches(prof, torch)
    per = max(it, 1)
    return {"pcg_iters": it, "wall_ms": wall * 1e3,
            "device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span else None,
            "exchange_share": exchange_us / busy if busy else None,
            "launches": launches, "launches_per_iter": launches / per,
            "host_kernel_launches_per_iter": host_k / per,
            "host_graph_launches_per_iter": host_g / per,
            "kernels": kernels}


def peak_bytes(solve, h, b, torch):
    """(peak allocated, peak reserved) device bytes of one solve, the
    allocator's cache emptied first (a graph's private pool stays: it is
    reserved, and its temporaries are not allocated at a replay)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solve(h, b)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()


def host_gap(solve, h, b, torch, runner, draws=5):
    """(median untraced wall ms of the graph solve, prologue ms, one
    iteration's device ms, host gap us per iteration)."""
    walls = []
    for _ in range(draws):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, it, _ = solve(h, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    pro, body = (replay_ms(g, torch) for g in runner.graphs)
    return wall, pro, body, host_gap_us(wall, it, pro, body)


def profile_path(name, h, solve, b, torch, out_dir):
    from saamge_tpu_torch.solve.device_pcg import solve_graphs
    rec = {"path": name}
    for loop in ("eager", "graph"):
        def run(h, b, loop=loop):
            return solve(h, b, graph=loop == "graph")
        r = trace_solve(run, h, b, torch)
        r["peak_allocated_bytes"], r["peak_reserved_bytes"] = \
            peak_bytes(run, h, b, torch)
        if loop == "graph":
            runner = solve_graphs(h).items[
                ("pcg", b.dtype, b.device, False)][1]
            (r["untraced_wall_ms"], r["prologue_ms"], r["iteration_ms"],
             r["host_gap_us_per_iter"]) = host_gap(run, h, b, torch, runner)
        rec[loop] = r
        extra = "" if loop == "eager" else (
            f" untraced_wall_ms={r['untraced_wall_ms']:.3f} "
            f"prologue_ms={r['prologue_ms']:.4f} "
            f"iteration_ms={r['iteration_ms']:.4f} "
            f"host_gap_us_per_iter={r['host_gap_us_per_iter']:.2f}")
        print(f"[{name} {loop}] pcg_iters={r['pcg_iters']} "
              f"wall_ms={r['wall_ms']:.3f} "
              f"device_busy_ms={r['device_busy_ms']:.3f} "
              f"span_ms={r['span_ms']:.3f} "
              f"idle_share={r['idle_share']:.4f} "
              f"exchange_share={r['exchange_share']:.4f} "
              f"launches_per_iter={r['launches_per_iter']:.1f} "
              f"host_kernel_launches_per_iter="
              f"{r['host_kernel_launches_per_iter']:.1f} "
              f"host_graph_launches_per_iter="
              f"{r['host_graph_launches_per_iter']:.2f} "
              f"peak_allocated_bytes={r['peak_allocated_bytes']} "
              f"peak_reserved_bytes={r['peak_reserved_bytes']}" + extra,
              flush=True)
        for k in r["kernels"][:15]:
            print(f"  {k['total_us']:10.1f} us  {k['calls']:5d} calls  "
                  f"{k['mean_us']:8.2f} us/call  {k['name'][:90]}")
    with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--general-n", type=int, default=64)
    ap.add_argument("--scale-n", type=int, default=128)
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
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.parallel.structured_sharded import (
        make_struct_sharded_pcg, scatter_fine, shard_structured)
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("[device]", torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, smi, flush=True)

    def s_solve(h, b, graph=True):
        return struct_pcg_solve(h, b, rel_tol=1e-6, graph=graph)

    def sharded_solve(hs, b, graph=True):
        x, it = make_struct_sharded_pcg(hs, graph=graph)(b, 1e-6)
        return x, it, None

    def g_solve(h, b, graph=True):
        return pcg_solve(h, b, rel_tol=1e-6, max_iter=300, graph=graph)

    if {"flagship", "capacity", "contract", "twolevel",
            "sharded"} & set(paths):
        ml, b, geo, supers, fac = flagship_problem(
            n=args.n, mfree=True, device_setup=True, device=dev)
        kw = {"flagship": {}, "sharded": {},
              "capacity": {"mfree": fac, "hbm_frugal": True,
                           "ainv_dtype": torch.bfloat16},
              "contract": {"rp_dtype": torch.float32,
                           "use_pallas_contract": True}}
        cpu = {p: compile_structured(ml, geo, supers, device="cpu", **kw[p])
               for p in kw if p in paths}
        if "twolevel" in paths:
            # level 0 alone: the coarsest inverse (the flagship's mid
            # level) is factored on the card
            ml2 = copy.copy(ml)
            ml2.levels = ml.levels[:1]
            cpu["twolevel"] = compile_structured(ml2, geo,
                                                 device=dev).to("cpu")
            del ml2
        del ml
        bd = torch.as_tensor(b, dtype=torch.float32, device=dev)
        for p, h_cpu in cpu.items():
            h = copy.deepcopy(h_cpu).to(dev)
            if p == "sharded":
                # the flagship hierarchy on 4 shards of the card
                hs = shard_structured(h, ShardMesh([dev] * 4))
                profile_path("sharded4", hs, sharded_solve,
                             scatter_fine(hs, bd), torch, out_dir)
                del hs
            else:
                profile_path(p, h, s_solve, bd, torch, out_dir)
            del h
            torch.cuda.empty_cache()
    if "general" in paths:
        ml, _, b = general_problem(n=args.general_n, device_setup=True,
                                   device=dev)
        h = compile_hierarchy(ml, torch.float32, device=dev)
        del ml
        bd = torch.as_tensor(b, dtype=torch.float32, device=dev)
        profile_path("general", h, g_solve, bd, torch, out_dir)
        del h
        torch.cuda.empty_cache()
    if "scale" in paths:
        from saamge_tpu_torch.drivers import run_scale_setup
        out, run = run_scale_setup.run(["--n", str(args.scale_n),
                                        "--device-rap", "--solve"])
        print("[scale] driver=" + json.dumps(out), flush=True)
        bd = torch.as_tensor(run.b, dtype=torch.float32, device=dev)
        profile_path("scale", run.h, s_solve, bd, torch, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
