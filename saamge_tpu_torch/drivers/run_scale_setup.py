"""Large-problem setup scaling run of the port (twin of the JAX package's
scripts/run_scale_setup.py).

Runs the flagship setup pipeline (Cartesian hex mesh, slab-add stencil
assembly, brick partitioning, spectral AE coarsening with the local
eigenproblems on ``--device`` unless ``--host-setup``, the multilevel
hierarchy, with ``--device-rap`` the finest Galerkin product on
``--device``) at multi-million-dof sizes, and prints one JSON line with
the per-phase wall times and the peak host RSS; with ``--solve`` also the
structured hierarchy compiled on ``--device``, its PCG iterations and, on
a card, the V-cycle time.

    python -m saamge_tpu_torch.drivers.run_scale_setup [--n 200]
        [--levels 3] [--device-rap] [--solve] [--hier-cache PATH]
        [--device cpu]

(n=200: 8,120,601 dofs.)  ``main(argv)`` prints and returns the JSON
dict; ``run(argv)`` returns it with the run's objects.

``--hier-cache PATH``: after the setup, pickle the solve bundle (the host
arrays compile_structured reads, as numpy and scipy objects) to PATH;
when PATH exists, skip the setup and solve from the bundle, so the solve
can run in a fresh process."""

from __future__ import annotations

import argparse
import json
import os
import pickle
import resource
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

from saamge_tpu_torch._device import card_or_cpu
from saamge_tpu_torch.utils.logging import TIMERS
from saamge_tpu_torch.utils.tables import Table

VCYCLE_DRAWS = 20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--brick", type=int, default=8)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--theta", type=float, default=1e-4)
    ap.add_argument("--contrast", type=float, default=2.0)
    ap.add_argument("--host-setup", action="store_true",
                    help="local eigenproblems on the host (no device "
                         "setup, no device RAP)")
    ap.add_argument("--solve", action="store_true",
                    help="also compile the structured hierarchy on "
                         "--device and run a PCG solve")
    ap.add_argument("--hier-cache", type=str, default=None,
                    help="pickle the solve bundle here / reuse it")
    ap.add_argument("--device-rap", action="store_true",
                    help="the finest Galerkin product on --device "
                         "(setup/device_rap.py)")
    ap.add_argument("--supers", type=int, default=0,
                    help="superbrick grid side for the 3rd level "
                         "(0 = auto: the divisor of nb nearest nb/4; "
                         "-1 = no superbricks, dense R1)")
    ap.add_argument("--frugal", action="store_true",
                    help="memory-frugal compile: packed mid blocks only, "
                         "bf16 coarsest inverse and, with --mfree, a "
                         "matrix-free f32 PCG operator")
    ap.add_argument("--mfree", action="store_true",
                    help="matrix-free smoother twin (ops/mfree.py) from "
                         "the element coefficient field")
    ap.add_argument("--rss-trace", action="store_true",
                    help="sample the current RSS every 2 s with the "
                         "active TIMERS phase (to stderr)")
    ap.add_argument("--device", default="cuda",
                    help="where the device work runs (default cuda; cpu "
                         "when asked)")
    return ap.parse_args(argv)


def _current_rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class RSSTrace:
    """Background sampler: (t, current RSS, peak RSS, TIMERS phase) lines
    to stderr whenever a phase reaches a new peak, every ``period``
    seconds; ``close()`` stops it and prints the peak of each phase."""

    def __init__(self, period: float = 2.0):
        self.peak_by_phase = {}
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, args=(period,),
                                        daemon=True)
        self._thread.start()

    def _pump(self, period):
        while not self._stop.wait(period):
            cur = _current_rss_gb()
            phase = ".".join(TIMERS.stack) or "-"
            if cur > self.peak_by_phase.get(phase, 0.0):
                self.peak_by_phase[phase] = cur
                print(f"[rss +{time.monotonic() - self._t0:7.1f}s] "
                      f"cur={cur:6.2f}G peak={_peak_rss_gb():6.2f}G  {phase}",
                      file=sys.stderr, flush=True)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)
        print("[rss] per-phase current-RSS peaks: " + json.dumps(
            {k: round(v, 2) for k, v in sorted(self.peak_by_phase.items(),
                                                key=lambda kv: -kv[1])}),
              file=sys.stderr, flush=True)


class DevicePeaks:
    """Peak allocated bytes on a card: of the whole run (``run``) and of
    named segments between two ``mark`` calls (``seg``, above the bytes
    allocated when the segment began: the device RAP, the compile, the
    solve).  Does nothing on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev if dev.type == "cuda" else None
        self.run, self.seg, self.base = 0, {}, 0
        self.mark()

    def mark(self, name=None):
        if self.dev is None:
            return
        torch.cuda.synchronize(self.dev)
        peak = torch.cuda.max_memory_allocated(self.dev)
        self.run = max(self.run, peak)
        if name is not None:
            self.seg[name] = peak - self.base
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.base = torch.cuda.memory_allocated(self.dev)


def solve_bundle(ml, b, out, supers=None, mfree=None) -> dict:
    """The arrays of the setup that compile_structured reads, as numpy
    and scipy objects (picklable without the package's classes)."""
    levels = []
    for i, lv in enumerate(ml.levels):
        tg, rels = lv.tg_data, lv.rels
        m2a, pd = rels.mis_to_AE, tg.poly_data
        d = {"num_mises": int(rels.num_mises), "nparts": int(rels.nparts),
             "mis_to_AE": (m2a.indptr, m2a.indices, int(m2a.ncols)),
             "smooth_interp": bool(tg.smooth_interp),
             "roots": np.asarray(pd.roots), "dinv": np.asarray(pd.dinv),
             "roots2": None if pd.roots2 is None else np.asarray(pd.roots2),
             "tent_interp": tg.tent_interp,
             "mis_numcoarsedof": np.asarray(
                 tg.interp_data.mis_numcoarsedof),
             "Ac": tg.Ac}
        if i == 0:
            d["A"] = lv.A
        else:
            d["restr"] = tg.restr
        levels.append(d)
    return {"levels": levels, "b": b, "out": out, "supers": supers,
            "mfree": mfree}


def bundle_ml(bundle: dict) -> types.SimpleNamespace:
    """The multilevel setup as compile_structured reads it, from a solve
    bundle."""
    NS = types.SimpleNamespace
    levels = []
    for d in bundle["levels"]:
        indptr, indices, ncols = d["mis_to_AE"]
        levels.append(NS(
            A=d.get("A"),
            rels=NS(num_mises=d["num_mises"], nparts=d["nparts"],
                    mis_to_AE=Table(indptr, indices, ncols)),
            tg_data=NS(
                smooth_interp=d["smooth_interp"],
                poly_data=NS(roots=d["roots"], roots2=d["roots2"],
                             dinv=d["dinv"]),
                tent_interp=d["tent_interp"], restr=d.get("restr"),
                interp_data=NS(mis_numcoarsedof=d["mis_numcoarsedof"]),
                Ac=d["Ac"])))
    return NS(levels=levels)


def _setup(args, dev, peaks):
    """The setup of scripts/run_scale_setup.py; returns the solve bundle
    (its ``out`` holds the JSON fields of the setup)."""
    from saamge_tpu_torch.api import SpectralAMGSolver, superbrick_grid
    from saamge_tpu_torch.config import SolverOptions
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    from saamge_tpu_torch.setup.device_rap import make_structured_rap_override
    from saamge_tpu_torch.solve.structured import BrickGeometry
    from saamge_tpu_torch.topology.part import (partition_cartesian_3d,
                                                partition_cartesian_bricks)
    nb = args.n // args.brick
    phases = {}
    t0 = time.perf_counter()
    mesh = hex_mesh(args.n)
    phases["mesh_s"] = round(time.perf_counter() - t0, 2)

    rng = np.random.default_rng(7)
    coefs = 10.0 ** rng.uniform(-args.contrast, args.contrast,
                                mesh.num_elements)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    t0 = time.perf_counter()
    # lazy_elem_mats: the factorized uniform-mesh batch, which the setup
    # consumes directly
    A, b, em, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess, lazy_elem_mats=True)
    phases["assemble_s"] = round(time.perf_counter() - t0, 2)
    ndof = A.shape[0]

    t0 = time.perf_counter()
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    phases["partition_s"] = round(time.perf_counter() - t0, 2)

    if args.levels < 3 or args.supers < 0:
        supers = None
    elif args.supers == 0:
        supers = superbrick_grid(nb)
    else:
        supers = (args.supers,) * 3 if args.supers > 1 else None
    override = None
    if supers:
        def override(level):
            return partition_cartesian_bricks((nb,) * 3, supers)
    opts = SolverOptions(
        num_levels=args.levels, correct_nulspace=False,
        first_theta=args.theta, theta=args.theta, nu_relax=[3, 1],
        device_setup=not args.host_setup)
    rap_override = rap = None
    if args.device_rap and not args.host_setup:
        rap = make_structured_rap_override(
            BrickGeometry((nb,) * 3, (args.brick,) * 3), device=dev)

        def rap_override(A_, tg, rels, level):
            peaks.mark()
            Ac = rap(A_, tg, rels, level)
            peaks.mark("rap" if Ac is not None else None)
            return Ac
    t0 = time.perf_counter()
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, coarse_part_override=override,
                          rap_override=rap_override, setup_device=dev)
    phases["setup_s"] = round(time.perf_counter() - t0, 2)
    phases["setup_device_pipeline_s"] = round(
        TIMERS.total("setup.device_pipeline"), 2)
    phases["setup_eig_phase_s"] = round(
        TIMERS.total("setup.device_pipeline.eigh"), 2)
    phases["setup_rap_s"] = round(TIMERS.total("setup.rap"), 2)
    phases["setup_rap_device_s"] = round(TIMERS.total("setup.rap_device"), 2)
    # the full accumulating-timer dump: the host setup's tail
    phases["timers"] = {k: round(v, 2)
                        for k, v in sorted(TIMERS.totals.items())}
    peaks.mark()
    out = {
        "metric": f"scale_setup_n{ndof}",
        "ndof": ndof,
        "levels": [lv.A.shape[0] for lv in s.ml.levels]
        + [s.ml.levels[-1].tg_data.Ac.shape[0]],
        "nnz": int(A.nnz),
        "phases": phases,
        # wall of the phases: setup_s holds the eigensolves and both RAPs
        "total_s": round(sum(phases[k] for k in (
            "mesh_s", "assemble_s", "partition_s", "setup_s")), 2),
        "peak_rss_gb": round(_peak_rss_gb(), 2),
        "platform": dev.type,
        "device_setup": not args.host_setup,
        # the override's stats hold bs once it took the device route
        "device_rap": bool(rap is not None and rap.stats),
    }
    if peaks.dev is not None:
        out["setup_peak_device_bytes"] = peaks.run
    if rap is not None:
        out["rap"] = rap.stats
    mfree = None
    if args.mfree:
        fac = assemble.diffusion_factorized(mesh, coefs)
        if fac is None:
            raise ValueError("the operator does not factorize per element")
        mfree = (fac[0], fac[1], ess_dofs)
    return solve_bundle(s.ml, b, out, supers=supers, mfree=mfree)


def _vcycle_draws(h, b, draws=VCYCLE_DRAWS):
    """ms of ``draws`` CUDA-event draws of one V-cycle (the replay of its
    captured graph), after two warm-up calls."""
    from saamge_tpu_torch.solve.structured import struct_vcycle_apply
    for _ in range(2):
        struct_vcycle_apply(h, b)
    torch.cuda.synchronize(b.device)
    times = []
    for _ in range(draws):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        struct_vcycle_apply(h, b)
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return times


def _solve(args, dev, bundle, ml, peaks):
    """Compile the structured hierarchy of ``ml`` (the bundle's setup) on
    ``dev`` and solve; adds the solve's fields to the bundle's ``out``;
    returns the hierarchy."""
    from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                                   compile_structured,
                                                   struct_pcg_solve)
    out, supers, mfree = bundle["out"], bundle["supers"], bundle["mfree"]
    nb = args.n // args.brick
    geo = BrickGeometry((nb,) * 3, (args.brick,) * 3)
    bf16 = torch.bfloat16
    use_mfree = args.mfree and mfree is not None
    t0 = time.perf_counter()
    h = compile_structured(ml, geo, supers, smoother_dtype=bf16,
                           rp_dtype=bf16, mid_dtype=bf16, device=dev,
                           mfree=mfree if use_mfree else None,
                           hbm_frugal=args.frugal,
                           ainv_dtype=bf16 if args.frugal else torch.float32)
    peaks.mark("compile")
    out.update(fine_layout="flat", supers=supers, mfree=use_mfree,
               mid_resident=h.mid_route == "resident", mid_route=h.mid_route,
               compile_s=round(time.perf_counter() - t0, 2))
    b = bundle["b"]
    bd = torch.as_tensor(b, dtype=torch.float32, device=dev)
    x, iters, nom = struct_pcg_solve(h, bd, max_iter=200)
    out["pcg_iters"] = int(iters)
    out["rel_res"] = float(nom)             # the final (B r, r), as in JAX
    A = ml.levels[0].A
    out["true_rel_res"] = float(np.linalg.norm(b - A @ x.double().cpu()
                                               .numpy()) / np.linalg.norm(b))
    if dev.type == "cuda":
        draws = _vcycle_draws(h, bd)
        ms = sorted(draws)[len(draws) // 2]
        peaks.mark("solve")
        out.update(vcycle_ms=ms, vcycle_ms_draws=draws,
                   dofs_per_sec=h.n / (ms / 1e3),
                   peak_device_bytes=peaks.run,
                   peak_device_bytes_by_phase=peaks.seg,
                   peak_hbm_gb=round(peaks.run / 1e9, 2),
                   hbm_limit_gb=round(torch.cuda.get_device_properties(
                       dev).total_memory / 1e9, 2))
    return h


def run(argv=None):
    """Parse ``argv``, set up (or load the bundle), solve when asked;
    returns (the JSON dict, the run's objects: ``ml`` the setup as
    compile_structured reads it, ``b``, ``supers``, ``h`` the hierarchy
    or None)."""
    args = parse_args(argv)
    dev = card_or_cpu(args.device)
    TIMERS.reset()
    trace = RSSTrace() if args.rss_trace else None
    try:
        peaks = DevicePeaks(dev)
        if args.hier_cache and os.path.exists(args.hier_cache):
            with open(args.hier_cache, "rb") as f:
                bundle = pickle.load(f)
            bundle["out"]["from_cache"] = True
        else:
            bundle = _setup(args, dev, peaks)
            if args.hier_cache:
                with open(args.hier_cache + ".tmp", "wb") as f:
                    pickle.dump(bundle, f)
                os.replace(args.hier_cache + ".tmp", args.hier_cache)
                bundle["out"]["hier_cache"] = args.hier_cache
        out = bundle["out"]
        ml = bundle_ml(bundle)
        h = _solve(args, dev, bundle, ml, peaks) if args.solve else None
        if dev.type == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip().splitlines()
            out["device"] = {"name": torch.cuda.get_device_name(dev),
                             "smi": smi[dev.index or 0]}
        out["peak_rss_run_gb"] = round(_peak_rss_gb(), 2)
    finally:
        if trace is not None:
            trace.close()
    return out, types.SimpleNamespace(ml=ml, b=bundle["b"],
                                      supers=bundle["supers"], h=h)


def main(argv=None) -> dict:
    out, _ = run(argv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
