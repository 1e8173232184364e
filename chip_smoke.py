#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the flagship n=96 problem

Phases (one line each; any failure raises and exits non-zero):
  1. device  -- requires a CUDA card; prints its name and power limit
  2. build   -- nvcc-builds the hand-written kernels (csrc/*.cu, sm_90a)
  3. setup   -- the flagship host setup (912,673 dofs at n=96) and the
                structured hierarchy, on the card and a CPU copy
  4. kernels -- each kernel against its plain torch version on the card,
                at the main path's shapes, with CUDA-event timings
  5. slice   -- V-cycle on the card vs the CPU copy (plain versions),
                PCG at 1e-6 and 1e-8 with the kernels' launch counts,
                V-cycle time
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}.  ``--n`` (and ``--brick``) shrink the
problem for development only."""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

FLAGSHIP_DIMS = [18917, 287]          # coarse dims of the n=96 flagship
PCG_MAX = {1e-6: 19, 1e-8: 25}        # JAX records 18 / 24 at n=96


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def median_ms(fn, torch, draws, calls=1):
    """Median over ``draws`` CUDA-event draws of the mean time of
    ``calls`` back-to-back calls (several calls per draw keep the card
    busy across the host's launch overhead for a short kernel)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(draws):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / calls)
    times.sort()
    return times[len(times) // 2]


def rel_err(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return abs_err, abs_err / max(scale, 1e-30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96,
                    help="mesh size (development only; default 96)")
    ap.add_argument("--brick", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from saamge_tpu_torch import (compile_structured, flagship_problem,
                                  struct_pcg_solve)
    from saamge_tpu_torch.ops import _build
    from saamge_tpu_torch.ops.midsmooth import mid_chain, mid_chain_plain
    from saamge_tpu_torch.ops.stencil import stencil_h, stencil_plain_h
    from saamge_tpu_torch.ops.wavefront import (wavefront_plain,
                                                wavefront_smooth)
    from saamge_tpu_torch.ops.window import (window_P, window_P_plain,
                                             window_R, window_R_plain)

    # 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build ----------------------------------------------------------
    _build.load()
    log("build", seconds=f"{_build.build_seconds:.2f}",
        sources=",".join(os.path.relpath(p) for p in _build.sources()),
        flags=" ".join(_build.NVCC_FLAGS))

    # 3. setup ----------------------------------------------------------
    t0 = time.perf_counter()
    supers = (2, 2, 2) if args.n < 32 else None
    ml, b_np, geo, supers = flagship_problem(n=args.n, brick=args.brick,
                                             supers=supers)
    setup_s = time.perf_counter() - t0
    dims = [int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
    t0 = time.perf_counter()
    h_cpu = compile_structured(ml, geo, supers)
    h = copy.deepcopy(h_cpu).to(dev)
    compile_s = time.perf_counter() - t0
    ndof = h.n
    log("setup", n=args.n, ndof=ndof, coarse_dims=dims, bs=h.bs,
        supers=supers, setup_s=f"{setup_s:.1f}",
        compile_s=f"{compile_s:.1f}", roots=(len(h.taus0), len(h.taus1)))
    if args.n == 96 and dims != FLAGSHIP_DIMS:
        raise RuntimeError(f"coarse dims {dims} != {FLAGSHIP_DIMS}")

    # 4. kernels --------------------------------------------------------
    rng = np.random.default_rng(0)

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m),
                               dtype=torch.float32).to(dev)

    A0, A0s = h.A0, h.A0s
    xh, bh = A0.pad(vec(ndof)), A0.pad(vec(ndof))
    r_f, xc = vec(ndof), vec(h.n_flat)
    b1, x1 = vec(h.n_flat), vec(h.n_flat)
    geo_args = (geo.bricks, geo.brick_elems)
    mid_args = (h.A1_blocks, h.doffs, h.rects, geo.bricks, h.taus1)
    cases = [
        ("stencil", stencil_h, 1e-5, "pallas_stencil.py:61",
         lambda: stencil_h("spmv", A0, xh),
         lambda: stencil_plain_h("spmv", A0, xh)),
        ("wavefront", wavefront_smooth, 1e-4, "pallas_wavefront.py:123",
         lambda: wavefront_smooth(A0s, h.taus0, bh, h.dinv0h, xh, True),
         lambda: wavefront_plain(A0s, h.taus0, bh, h.dinv0h, xh, True)),
        ("window_R", window_R, 1e-5, "pallas_window.py:144",
         lambda: window_R(h.Rst, r_f, *geo_args),
         lambda: window_R_plain(h.Rst, r_f, *geo_args)),
        ("window_P", window_P, 1e-5, "pallas_window.py:193",
         lambda: window_P(h.Rst, xc, *geo_args),
         lambda: window_P_plain(h.Rst, xc, *geo_args)),
        ("mid_chain", mid_chain, 1e-4, "pallas_midsmooth.py:136",
         lambda: mid_chain(*mid_args[:4], h.taus1, b1, h.dinv1, x1, True),
         lambda: mid_chain_plain(h.A1_blocks, h.doffs, geo.bricks,
                                 h.taus1, b1, h.dinv1, x1, True)),
    ]
    # the stencil kernel's residual and root modes (the sweep kernel does
    # their work on the main path), on the bf16 twin: correctness only
    for mode, kw in (("residual", {"bh": bh}),
                     ("root", {"bh": bh, "dinvh": h.dinv0h,
                               "inv_tau": h.taus0[0]})):
        _, rel = rel_err(stencil_h(mode, A0s, xh, **kw),
                         stencil_plain_h(mode, A0s, xh, **kw))
        log("kernel", name=f"stencil_{mode}_bf16",
            max_rel_err=f"{rel:.3e}", tol=1e-5)
        if not rel <= 1e-5:
            raise RuntimeError(f"stencil {mode}: rel err {rel:.3e}")
    sources = {"stencil": "stencil.cu", "wavefront": "wavefront.cu",
               "window_R": "window.cu", "window_P": "window.cu",
               "mid_chain": "midsmooth.cu"}
    records = []
    for name, wrapper, tol, replaces, kern, plain in cases:
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        ms = median_ms(kern, torch, draws=5, calls=20)
        plain_ms = median_ms(plain, torch, draws=5, calls=4)
        log("kernel", name=name, max_abs_err=f"{abs_err:.3e}",
            max_rel_err=f"{rel:.3e}", tol=tol, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        if not rel <= tol:
            raise RuntimeError(f"{name}: rel err {rel:.3e} > {tol}")
        records.append({"name": name, "route": "cuda",
                        "source": f"saamge_tpu_torch/csrc/{sources[name]}",
                        "replaces": f"saamge_tpu/ops/{replaces}",
                        "wrapper": wrapper, "max_abs_err": abs_err,
                        "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms})

    # 5. slice ----------------------------------------------------------
    b = torch.as_tensor(b_np, dtype=torch.float32)
    bd = b.to(dev)
    y_dev = h.vcycle(bd)
    y_cpu = h_cpu.vcycle(b)
    abs_err, rel = rel_err(y_dev.cpu(), y_cpu)
    log("slice", vcycle_vs_cpu_rel_err=f"{rel:.3e}", tol=1e-4)
    if not rel <= 1e-4:
        raise RuntimeError(f"V-cycle card vs CPU rel err {rel:.3e}")

    for rec in records:
        rec["wrapper"].launches = 0
    t0 = time.perf_counter()
    _, it6, _ = struct_pcg_solve(h, bd, rel_tol=1e-6)
    torch.cuda.synchronize()
    pcg6_s = time.perf_counter() - t0
    for rec in records:
        rec["launches"] = rec.pop("wrapper").launches
    log("slice", launches={r["name"]: r["launches"] for r in records})
    idle = [r["name"] for r in records if r["launches"] < 1]
    if idle:
        raise RuntimeError(f"kernels not launched by the PCG: {idle}")
    t0 = time.perf_counter()
    x8, it8, _ = struct_pcg_solve(h, bd, rel_tol=1e-8)
    torch.cuda.synchronize()
    pcg8_s = time.perf_counter() - t0
    _, it6_cpu, _ = struct_pcg_solve(h_cpu, b, rel_tol=1e-6)
    # true residual of the card's solution against the host f64 operator
    xs = x8.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_np - ml.levels[0].A @ xs)
                     / np.linalg.norm(b_np))
    finite = bool(torch.isfinite(x8).all()) and x8.shape == (ndof,)
    vms = median_ms(lambda: h.vcycle(bd), torch, draws=20)
    log("slice", pcg_iters_1e6=it6, pcg_iters_1e8=it8,
        pcg_iters_1e6_cpu=it6_cpu, pcg_1e6_s=f"{pcg6_s:.3f}",
        pcg_1e8_s=f"{pcg8_s:.3f}",
        pcg_1e8_ms_per_iter=f"{pcg8_s * 1e3 / max(it8, 1):.4f}",
        true_rel_res_1e8=f"{true_res:.3e}",
        vcycle_ms=f"{vms:.4f}", dofs_per_s=f"{ndof / (vms / 1e3):.4e}")
    if not finite:
        raise RuntimeError("PCG solution is not finite or has the wrong "
                           "shape")
    if abs(it6 - it6_cpu) > 1:
        raise RuntimeError(f"card PCG {it6} vs CPU PCG {it6_cpu} iterations")
    if not true_res <= 1e-3:
        raise RuntimeError(f"true relative residual {true_res:.3e}")
    if args.n == 96 and (it6 > PCG_MAX[1e-6] or it8 > PCG_MAX[1e-8]):
        raise RuntimeError(f"PCG iterations {it6}/{it8} above "
                           f"{PCG_MAX[1e-6]}/{PCG_MAX[1e-8]}")

    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
