#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the flagship n=96 problem

Phases (one line each; any failure raises and exits non-zero):
  1. device   -- requires a CUDA card; prints its name and power limit
  2. build    -- nvcc-builds the hand-written kernels (csrc/*.cu, sm_90a),
                 one nvcc per source, in parallel
  3. setup    -- ONE flagship host setup (912,673 dofs at n=96) with the
                 matrix-free factors; from it the flagship hierarchy and
                 the full-capacity one (mfree + hbm_frugal + bf16
                 coarsest inverse), each on the CPU
  4. flagship -- on the card: its kernels against their plain torch
                 versions (CUDA-event timings), then the slice: V-cycle vs
                 the CPU copy, PCG at 1e-6 (launch counts) and 1e-8,
                 V-cycle time, peak device memory and buffer bytes
  5. capacity -- the same for the capacity hierarchy and its kernels
                 (matrix-free fine operator, packed mid matvec); its PCG
                 must launch no kernel of the stored-operator path
The flagship hierarchy leaves the card before the capacity one arrives,
so each path's peak device memory is its own.  The last two lines are
the kernels' JSON record and the result line {"ok": true, "device":
{...}}.  ``--n`` (and ``--brick``) shrink the problem for development
only."""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import subprocess
import sys
import time

FLAGSHIP_DIMS = [18917, 287]          # coarse dims of the n=96 flagship
PCG_MAX = {1e-6: 19, 1e-8: 25}        # JAX records 18 / 24 at n=96
TOLS = (1e-6, 1e-8)
T0 = time.perf_counter()


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


def buffer_bytes(h) -> int:
    return sum(b.numel() * b.element_size() for b in h.buffers())


def run_kernels(cases, torch):
    """Each kernel against its plain version on the same card tensors;
    returns the kernels' records."""
    records = []
    for name, tol, source, replaces, kern, plain in cases:
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
                        "source": f"saamge_tpu_torch/csrc/{source}",
                        "replaces": f"saamge_tpu/ops/{replaces}",
                        "max_abs_err": abs_err,
                        "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms})
    return records


def run_slice(path, h, h_cpu, b_np, A_host, wrappers, torch, np):
    """V-cycle on the card vs the CPU copy, PCG at both tolerances (the
    launch counts of every wrapper during the 1e-6 solve), the true
    residual, V-cycle time and the peak device memory of the solve."""
    from saamge_tpu_torch import struct_pcg_solve
    dev = next(h.buffers()).device
    b = torch.as_tensor(b_np, dtype=torch.float32)
    bd = b.to(dev)
    _, rel = rel_err(h.vcycle(bd).cpu(), h_cpu.vcycle(b))
    log(path, vcycle_vs_cpu_rel_err=f"{rel:.3e}", tol=1e-4,
        at_s=f"{time.perf_counter() - T0:.1f}")
    if not rel <= 1e-4:
        raise RuntimeError(f"{path}: V-cycle card vs CPU rel err {rel:.3e}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    _, it6, _ = struct_pcg_solve(h, bd, rel_tol=1e-6)
    torch.cuda.synchronize()
    pcg6_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    log(path, launches=launches)
    t0 = time.perf_counter()
    x8, it8, _ = struct_pcg_solve(h, bd, rel_tol=1e-8)
    torch.cuda.synchronize()
    pcg8_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    it6_cpu = struct_pcg_solve(h_cpu, b, rel_tol=1e-6)[1]
    xs = x8.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_np - A_host @ xs)
                     / np.linalg.norm(b_np))
    finite = bool(torch.isfinite(x8).all()) and x8.shape == (h.n,)
    vms = median_ms(lambda: h.vcycle(bd), torch, draws=20)
    out = {"pcg_iters_1e6": it6, "pcg_iters_1e8": it8,
           "pcg_iters_1e6_cpu": it6_cpu, "pcg_1e6_s": f"{pcg6_s:.3f}",
           "pcg_1e8_s": f"{pcg8_s:.3f}",
           "pcg_1e8_ms_per_iter": f"{pcg8_s * 1e3 / max(it8, 1):.4f}",
           "true_rel_res_1e8": f"{true_res:.3e}",
           "vcycle_ms": f"{vms:.4f}",
           "dofs_per_s": f"{h.n / (vms / 1e3):.4e}",
           "buffer_bytes": buffer_bytes(h), "resident_bytes": resident,
           "peak_bytes_pcg": peak}
    log(path, **out)
    if not finite:
        raise RuntimeError(f"{path}: PCG solution is not finite or has the "
                           "wrong shape")
    if abs(it6 - it6_cpu) > 1:
        raise RuntimeError(f"{path}: card PCG {it6} vs CPU PCG {it6_cpu} "
                           "iterations")
    if not true_res <= 1e-3:
        raise RuntimeError(f"{path}: true relative residual {true_res:.3e}")
    out.update(launches=launches, it=(it6, it8))
    return out


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
    from saamge_tpu_torch import compile_structured, flagship_problem
    from saamge_tpu_torch.ops import _build
    from saamge_tpu_torch.ops.mfree import mfree_h, mfree_plain_h
    from saamge_tpu_torch.ops.midmv import midmv, midmv_plain
    from saamge_tpu_torch.ops.midsmooth import mid_chain, mid_chain_plain
    from saamge_tpu_torch.ops.stencil import stencil_h, stencil_plain_h
    from saamge_tpu_torch.ops.wavefront import (wavefront_plain,
                                                wavefront_smooth)
    from saamge_tpu_torch.ops.window import (window_P, window_P_plain,
                                             window_R, window_R_plain)
    wrappers = {"stencil": stencil_h, "wavefront": wavefront_smooth,
                "window_R": window_R, "window_P": window_P,
                "mid_chain": mid_chain, "mfree": mfree_h, "midmv": midmv}

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
    ml, b_np, geo, supers, fac = flagship_problem(
        n=args.n, brick=args.brick, supers=supers, mfree=True)
    setup_s = time.perf_counter() - t0
    dims = [int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
    A_host = ml.levels[0].A
    t0 = time.perf_counter()
    h_cpu = compile_structured(ml, geo, supers)
    hc_cpu = compile_structured(ml, geo, supers, mfree=fac, hbm_frugal=True,
                                ainv_dtype=torch.bfloat16)
    compile_s = time.perf_counter() - t0
    ndof = h_cpu.n
    del ml
    log("setup", n=args.n, ndof=ndof, coarse_dims=dims, bs=h_cpu.bs,
        supers=supers, setup_s=f"{setup_s:.1f}",
        compile_s=f"{compile_s:.1f}",
        roots=(len(h_cpu.taus0), len(h_cpu.taus1)))
    if args.n == 96 and dims != FLAGSHIP_DIMS:
        raise RuntimeError(f"coarse dims {dims} != {FLAGSHIP_DIMS}")
    rng = np.random.default_rng(0)

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m),
                               dtype=torch.float32).to(dev)

    # 4. flagship -------------------------------------------------------
    torch.cuda.empty_cache()
    h = copy.deepcopy(h_cpu).to(dev)
    A0, A0s = h.A0, h.A0s
    xh, bh = A0.pad(vec(ndof)), A0.pad(vec(ndof))
    r_f, xc = vec(ndof), vec(h.n_flat)
    b1, x1 = vec(h.n_flat), vec(h.n_flat)
    geo_args = (geo.bricks, geo.brick_elems)
    mid_args = (h.A1_blocks, h.doffs, h.rects, geo.bricks, h.taus1)
    root_kw = {"bh": bh, "dinvh": h.dinv0h, "inv_tau": h.taus0[0]}
    records = run_kernels([
        ("stencil", 1e-5, "stencil.cu", "pallas_stencil.py:61",
         lambda: stencil_h("spmv", A0, xh),
         lambda: stencil_plain_h("spmv", A0, xh)),
        ("wavefront", 1e-4, "wavefront.cu",
         "pallas_wavefront.py:123",
         lambda: wavefront_smooth(A0s, h.taus0, bh, h.dinv0h, xh, True),
         lambda: wavefront_plain(A0s, h.taus0, bh, h.dinv0h, xh, True)),
        ("window_R", 1e-5, "window.cu", "pallas_window.py:144",
         lambda: window_R(h.Rst, r_f, *geo_args),
         lambda: window_R_plain(h.Rst, r_f, *geo_args)),
        ("window_P", 1e-5, "window.cu", "pallas_window.py:193",
         lambda: window_P(h.Rst, xc, *geo_args),
         lambda: window_P_plain(h.Rst, xc, *geo_args)),
        ("mid_chain", 1e-4, "midsmooth.cu",
         "pallas_midsmooth.py:136",
         lambda: mid_chain(*mid_args[:4], h.taus1, b1, h.dinv1, x1, True),
         lambda: mid_chain_plain(h.A1_blocks, h.doffs, geo.bricks,
                                 h.taus1, b1, h.dinv1, x1, True)),
    ], torch)
    # the stencil kernel's residual and root modes on the bf16 twin (the
    # sweep kernel does their work on the main path); the root pass is
    # timed beside the matrix-free root of phase 5
    for mode, kw in (("residual", {"bh": bh}), ("root", root_kw)):
        _, rel = rel_err(stencil_h(mode, A0s, xh, **kw),
                         stencil_plain_h(mode, A0s, xh, **kw))
        ms = median_ms(lambda: stencil_h(mode, A0s, xh, **kw), torch,
                       draws=5, calls=20)
        log("kernel", name=f"stencil_{mode}_bf16", max_rel_err=f"{rel:.3e}",
            tol=1e-5, ms=f"{ms:.4f}")
        if not rel <= 1e-5:
            raise RuntimeError(f"stencil {mode}: rel err {rel:.3e}")
    mid_full = h.A1_blocks.numel() * h.A1_blocks.element_size()
    del A0, A0s, xh, bh, r_f, xc, b1, x1, mid_args, root_kw
    flag = run_slice("flagship", h, h_cpu, b_np, A_host, wrappers, torch, np)
    idle = [k for k in ("stencil", "wavefront", "window_R", "window_P",
                        "mid_chain") if flag["launches"][k] < 1]
    if idle:
        raise RuntimeError(f"kernels not launched by the flagship PCG: "
                           f"{idle}")
    it6, it8 = flag["it"]
    if args.n == 96 and (it6 > PCG_MAX[1e-6] or it8 > PCG_MAX[1e-8]):
        raise RuntimeError(f"PCG iterations {it6}/{it8} above "
                           f"{PCG_MAX[1e-6]}/{PCG_MAX[1e-8]}")
    del h, h_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # 5. capacity -------------------------------------------------------
    hc = copy.deepcopy(hc_cpu).to(dev)
    C0, C0s = hc.A0, hc.A0s
    xh, bh = C0.pad(vec(ndof)), C0.pad(vec(ndof))
    x1 = vec(hc.n_flat)
    root_kw = {"bh": bh, "dinvh": hc.dinv0h, "inv_tau": hc.taus0[0]}
    mv_args = (hc.A1_packed, hc.doffs, hc.rects, geo.bricks, hc.bs, x1)
    records += run_kernels([
        ("mfree", 1e-5, "mfree.cu", "pallas_mfree.py:100",
         lambda: mfree_h("root", C0s, xh, **root_kw),
         lambda: mfree_plain_h("root", C0s, xh, **root_kw)),
        ("midmv", 1e-5, "midmv.cu", "pallas_midmv.py:142",
         lambda: midmv(*mv_args), lambda: midmv_plain(*mv_args)),
    ], torch)
    records[-2]["case"] = "root, bf16 c/m"
    records[-1]["case"] = f"{hc.A1_packed.dtype} packed blocks"
    for mode, op, kw in (("spmv", C0, {}), ("residual", C0s, {"bh": bh})):
        _, rel = rel_err(mfree_h(mode, op, xh, **kw),
                         mfree_plain_h(mode, op, xh, **kw))
        ms = median_ms(lambda: mfree_h(mode, op, xh, **kw), torch,
                       draws=5, calls=20)
        log("kernel", name=f"mfree_{mode}_{str(op.c_h.dtype)[6:]}",
            max_rel_err=f"{rel:.3e}", tol=1e-5, ms=f"{ms:.4f}")
        if not rel <= 1e-5:
            raise RuntimeError(f"mfree {mode}: rel err {rel:.3e}")
    mid_packed = hc.A1_packed.numel() * hc.A1_packed.element_size()
    del C0, C0s, xh, bh, x1, root_kw, mv_args
    cap = run_slice("capacity", hc, hc_cpu, b_np, A_host, wrappers, torch,
                    np)
    must = {k: cap["launches"][k] for k in ("mfree", "midmv", "window_R",
                                            "window_P")}
    never = {k: cap["launches"][k] for k in ("stencil", "wavefront",
                                             "mid_chain")}
    if min(must.values()) < 1 or max(never.values()) > 0:
        raise RuntimeError(f"capacity PCG launches: need > 0 {must}, "
                           f"need 0 {never}")
    for tol, a, c in zip(TOLS, flag["it"], cap["it"]):
        if abs(a - c) > 2:
            raise RuntimeError(f"capacity PCG {c} vs flagship {a} "
                               f"iterations at {tol}")
    diags = 27 * ndof * (4 + 2)
    log("memory", flagship_buffer_bytes=flag["buffer_bytes"],
        capacity_buffer_bytes=cap["buffer_bytes"],
        stored_diagonal_bytes=diags, full_mid_block_bytes=mid_full,
        packed_mid_bytes=mid_packed,
        flagship_peak_bytes=flag["peak_bytes_pcg"],
        capacity_peak_bytes=cap["peak_bytes_pcg"])
    if cap["buffer_bytes"] > flag["buffer_bytes"] - diags:
        raise RuntimeError("the capacity hierarchy is not smaller than the "
                           "flagship by the stored f32 + bf16 diagonals")

    for rec in records:
        path = cap if rec["name"] in ("mfree", "midmv") else flag
        rec["launches"] = path["launches"][rec["name"]]
    log("done", seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
