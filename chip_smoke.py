#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # flagship n=96, general path n=64

Phases (one line each; any failure raises and exits non-zero):
  1. device   -- requires a CUDA card; prints its name and power limit
  2. build    -- nvcc-builds the hand-written kernels (csrc/*.cu, sm_90a),
                 one nvcc per source, in parallel; prints ptxas's
                 registers, shared bytes and spills of the packed mid
                 matvec, window R / P, sweep, mid chain, matrix-free
                 pass and chain, and contract R / P kernels
  2b. ragged  -- those kernels against their plain versions: brick grids
                 with no side a multiple of a tile ((5,3,7), odd: the
                 scalar-load path; (6,5,4), even: the 2-wide one),
                 bs = 13, ragged rectangles (r1 = 0, r2 = bs, (bs, bs)),
                 brick_elems (4,4,4) and (8,8,8), f32 and bf16, every
                 matvec mode, window P on dense and sparse slot ranges;
                 contract R and P (f32 and bf16, dense and sparse, NB =
                 130 and 64; P bit-equal to its full-range launch, both
                 raising without their tables);
                 the sweep on odd grids, 1 / 2 / 10 roots, with and
                 without the residual, 27 and 7 taps; the resident mid
                 chain with tiles of 2, 8 and 14 bricks, 1 / 4 roots,
                 +- residual; the matrix-free pass (every mode, equal bit
                 for bit to the one-thread-a-node reference) and chain (1
                 / 10 roots, +- residual, equal bit for bit to its single
                 passes) on odd node grids; two launches must agree bit
                 for bit
  3. setup    -- ONE flagship setup (912,673 dofs at n=96) with the
                 matrix-free factors, its local eigenproblems on the card
                 (device_setup=True, as bench.py: the uniform-brick
                 pipeline, 1,728 AEs of 729 dofs through the Chebyshev
                 filter); prints the setup seconds and the timers' split
                 (setup.device_pipeline and its .eigh / .fetch / .aes /
                 .rr, the rest on the host), the AEs per eigensolver route
                 (filter, eigh, host, exact host re-solve) per level, the
                 setup's peak device bytes, allow_tf32, and the filter
                 round's GFLOP/s beside torch.bmm at (512, 729, 64); from
                 it the flagship hierarchy, the full-capacity one (mfree +
                 hbm_frugal + bf16 coarsest inverse), the box-
                 contraction one (f32 tent blocks, use_pallas_contract)
                 and those of phase 9, each on the CPU; then the device
                 Galerkin product (setup/device_rap.py) of its level 0 on
                 the card against the host f64 product P^T A P (the
                 setup's tg0.Ac, recomputed and timed here; within
                 1e-5 of max |Ac|, equal nnz; its seconds beside the host
                 product's, timed in the same run, bs, the reckoned and
                 the peak device bytes) and the device element matrices
                 (fem/assemble_device.py) of the n=96 mesh against the
                 host f64 ones (within 1e-5 relative; elements/s of both)
  3b. parity  -- the host and the device setup of a small flagship (n=32,
                 superbricks (2,2,2): the uniform pipeline) and a small
                 hexkway (n=24: the generic batched eigensolver): per AE
                 the same cut count (every level) and B-projectors within
                 5e-3 (finest level), equal coarse dims, host f64 PCG
                 iterations within 1
  4. flagship -- on the card: its kernels against their plain torch
                 versions (CUDA-event timings `ms`; `device_ms`, the
                 kernels' own device time per call from one profiler
                 window; `host_us`, the host time per wrapper call; the
                 bound; the library call's times), then
                 the slice: the V-cycle (its captured CUDA graph) vs the
                 CPU copy and vs the eager cycle; PCG at 1e-6 and 1e-8 by
                 the eager loop (graph=False; its 1e-6 solve gives the
                 launch counts) and by the graph loop (the default: the
                 prologue and each iteration replayed as captured
                 graphs), each with its ms per iteration, V-cycle time,
                 dofs/s and peak device bytes; the graph loop must take
                 the eager loop's iterations, give its x bit for bit
                 (within 1e-5 and one iteration on the general path), run
                 each port kernel as often as the eager loop launched it
                 (device kernel records of one profiler window), and do
                 the same for a second right-hand side through the same
                 graphs; buffer bytes; the mid chain must take the
                 resident route (its tiles, threads and shared bytes are
                 printed)
  5. capacity -- the same for the capacity hierarchy and its kernels
                 (matrix-free pass and chain, packed mid matvec and its
                 residual and root modes); its PCG must launch no kernel
                 of the stored-operator path, the matrix-free chain for
                 each smoothing chain, the single pass only as spmv (the
                 PCG matvec), and the packed pass in its root and
                 residual modes
  6. contract -- the same for the box-contraction hierarchy and its two
                 kernels (R on the by-slot node lists, P on the slot
                 ranges; the bound counts the tent's nonzero values and
                 the two vectors, beside the bytes of the 32-byte sectors
                 that hold them); both must repeat bit for bit, and P
                 equal its launch with full ranges; its PCG launches no
                 window kernel and must take within one iteration of the
                 flagship's
  7. general  -- the general (unstructured) path: the hexkway setup
                 (generic k-way agglomeration, 274,625 dofs at n=64, 3
                 levels; device_setup=True: the batched eigensolver on the
                 card, its split and routes as in phase 3; other coarse
                 dims than [16652, 367] raise with the per-AE difference
                 from the host setup), compile_hierarchy, the fused
                 smoother kernel, the block-row kernel in each product of
                 the V-cycle (R0, the level-1 root and residual, R1, P1,
                 P0; bit for bit equal to blockrow_plain and to its own
                 repeat, beside the CSR product of the same matrix),
                 the coarsest product (csrc/symv.cu, 367 dofs) bit for
                 bit against symv_plain, beside torch's product with the
                 dense inverse and the triangular solve pair it replaced,
                 then the slice; its PCG launches the smoother, the
                 stencil, the block-row kernel in its four modes and the
                 coarsest product and no structured-only kernel, and its
                 V-cycles take no plain block-row or coarsest route
                 (counters ``blockrow.kernel`` / ``blockrow.plain``,
                 ``symv.kernel`` / ``symv.plain``: one product a
                 V-cycle) and run no triangular solve; the kernels of
                 one body replay of the PCG graph, counted from profiler
                 records
  7b. elasticity -- 3D linear elasticity on the general path
                 (``elasticity_problem``: 206,763 dofs at n=40, one face
                 clamped, k-way agglomerates of 128 / 64 elements, the
                 rigid-body modes; device setup as phase 7): its finest
                 level must be the node-block format (27 offsets, 10
                 roots) and ``vstencil.bytes`` the bytes of its values;
                 the node-block kernel (csrc/vstencil.cu) in each mode at
                 the level's shapes against vstencil_plain, beside the
                 plain ELL product or chain of the same level (the
                 record's library times), and bit for bit against it on
                 ragged node grids (27 and 7 offsets, 1 / 10 / 33 roots,
                 +- residual); the coarsest product at ~9.5k dofs
                 (``symv.bytes`` the bytes of its tiles) as in phase 7;
                 then the slice (no CPU PCG); its PCG launches the
                 node-block chain and pass, the block-row kernel and one
                 coarsest product a V-cycle, and no fused smoother,
                 stencil, triangular solve or plain node-block or
                 coarsest route
  8. twolevel -- the flagship setup's level 0 alone (a two-level
                 hierarchy: its coarsest level is the flagship's mid
                 level, 18,917 dofs at n=96), compiled on the card in
                 phase 3 (3c: the coarsest inverse by the card's f32
                 Cholesky, its seconds and the compile's peak device
                 bytes, against the f64 inverse rounded to f32), then its
                 slice; its PCG launches no mid-level kernel, and takes
                 within one iteration of the same hierarchy with the
                 f32-rounded f64 inverse
  9. options  -- three more hierarchies of the flagship setup, each
                 through the slice: the dense coarsest restriction R1
                 (``super_bricks=None``: the flagship's kernels, its
                 iterations exactly and its V-cycle within 1e-4), the
                 dense mid operator (``mid_format='dense'``: a bf16-in /
                 f32-out cuBLAS product, no mid kernel; the CPU copy
                 checks one V-cycle, not a PCG) and the packed mid passes
                 (``mid_resident=False``: midmv root and residual, no mid
                 chain), the last two within one iteration of the
                 flagship's
  9b. sharded -- the flagship hierarchy split into x-slabs over a shard
                 mesh of the one card (saamge_tpu_torch/parallel/): the
                 device setup's sharded Galerkin product (4 shards)
                 against the host and the one-device products (phase 3);
                 the stencil (three modes, f32 and bf16 diagonals) and
                 window R / P on 4-shard slabs against their plain
                 versions (records ``stencil_slab``, ``window_R_slab``,
                 ``window_P_slab``), window R / P on slabs of 1, BX/4
                 and BX/2 brick layers, and the stencil on a one-plane
                 slab, equal bit for bit to the single-card rows; then
                 the slice on 1, 2 and 4 shards (the V-cycle against a
                 CPU-sharded copy and within 1e-3 of the single-card
                 flagship's, graph against eager, equal iterations at
                 every shard count, within one of the flagship's), the
                 replicated mid on 4 shards (resident chain and packed
                 passes: their launches, graph = eager), and the
                 production-regime check (parallel/checks.py) at ns=48,
                 bricks of 6, on 2 and 4 shards
  10. scale   -- the scale-setup driver
                 (saamge_tpu_torch/drivers/run_scale_setup.py) called in
                 this process with --n 128 --device-rap --solve (2,146,689
                 dofs, superbricks (4,4,4), setup, device RAP and compile
                 on the card); its JSON line; the setup's device Ac against
                 the host f64 product of the same level 0 (within 1e-5 of
                 max |Ac|, equal nnz) and against a second device product
                 (bit for bit; its seconds, bs and peak device bytes);
                 each kernel of the path against its plain version at
                 the hierarchy's own shapes (the stencil's spmv, the
                 sweep, window R and P, the packed mid passes' residual
                 and root, or the resident mid chain); then the slice of
                 its hierarchy against its CPU copy (V-cycle within
                 1e-4, PCG within one iteration) and within the path's
                 iteration limits
Each hierarchy leaves the card before the next arrives, so each path's
peak device memory is its own, but for ~69 MB a path that stays
allocated after it (PERF.md §7); each ``[leave_card]`` line gives the
bytes allocated before and after the collection at a path's exit.  The
last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}.

Development options (the run with no arguments is the full check):
``--n``, ``--brick``, ``--general-n`` and ``--elasticity-n`` shrink the
problems; ``--paths`` runs some of flagship, capacity, contract,
general, elasticity, twolevel, options, sharded and scale; ``--scale-n 200`` runs the scale path at
the driver's default size (8,120,601 dofs);
``--kernels-only`` stops each path after its kernel phase (no V-cycle,
no PCG); ``--host-setup`` builds both paths' hierarchies with the host
setup (device_setup=False; no phase 3b), for the host-against-device
setup time; ``--general-n 100`` logs the general path against the JAX
record (coarse dims [61300, 1984], PCG 23 / 30);
``--cards 4`` (a machine of four cards) runs only the flagship setup
and the 4-shard solve spread over the cards against 4 shards of one
card; ``--synthetic`` skips every host setup and times the stencil,
the sweep, the resident mid chain and the matrix-free pass and chain on
n=96-shaped operands made from a numpy seed (with each chain's time per
level and the time of one grid barrier of its grid), and the general
smoother on n=64-shaped ones."""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import re
import subprocess
import sys
import time

from perfbench.harness.timing import median_ms

FLAGSHIP_DIMS = [18917, 287]          # coarse dims of the n=96 flagship
PCG_MAX = {1e-6: 19, 1e-8: 25}        # JAX records 18 / 24 at n=96
GENERAL_DIMS = [16652, 367]           # coarse dims of hexkway n=64
GENERAL_PCG_MAX = {1e-6: 18, 1e-8: 22}  # host f64 PCG 17 / 21, plus 1
# the JAX record of the hexkway general run (GENERAL_r05_hexkway.json):
# coarse dims and PCG iterations at 1e-6 / 1e-8
GENERAL_JAX = {100: ([61300, 1984], [23, 30])}
# the scale path's PCG limits at 1e-6 / 1e-8: the card's 22 / 29 at n=128
# plus 1; at n=200 the JAX record's 29 (PARITY.md) and the card's 39, plus 1
SCALE_PCG_MAX = {128: {1e-6: 23, 1e-8: 30}, 200: {1e-6: 30, 1e-8: 40}}
TOLS = (1e-6, 1e-8)
PATHS = ("flagship", "capacity", "contract", "general", "elasticity",
         "twolevel", "options", "sharded", "scale")
# the paths built on the flagship setup
STRUCTURED = ("flagship", "capacity", "contract", "twolevel", "options",
              "sharded")
HBM_BYTES_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_S = 67e12          # H100 SXM f32 outside the tensor cores
T0 = time.perf_counter()


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def device_ms(fn, torch, device_profile, calls=20, windows=3):
    """Mean device time per call of the CUDA kernels that ``fn``
    launches, from one torch.profiler window over ``calls`` calls.  A
    window in which the profiler delivered no kernel record (seen now
    and then on the card's machine) is taken again, up to ``windows``
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        _, _, by_name = device_profile(prof, torch)
        if by_name:
            return sum(t for _, t in by_name.values()) / calls / 1e3
    raise RuntimeError(f"the profiler recorded no device kernel in "
                       f"{windows} windows")


def host_us(fn, torch, calls=20):
    """Host time per call over ``calls`` enqueues, before the
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def rel_err(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return abs_err, abs_err / max(scale, 1e-30)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def buffer_bytes(h) -> int:
    return nbytes(*h.buffers())


def bound(work):
    """Least time of the card for (bytes moved, f32 operations): each
    input read once and each output written once over the memory rate,
    or the operations over the f32 rate, whichever is larger."""
    nb, flops = work
    tb, tf = nb / HBM_BYTES_S, flops / F32_FLOP_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def sparse_csr(rows, cols, vals, shape, torch):
    """A CSR matrix from COO triplets (duplicates summed)."""
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                   shape).coalesce().to_sparse_csr()


def tent_csr(Rst, bricks, brick_elems, torch):
    """The tent restriction of ``Rst`` on a brick grid as a (bs*NB, n)
    CSR matrix and its transpose, with the values of Rst widened to f32
    (n: the grid's nodes)."""
    from saamge_tpu_torch.ops.window import box_index
    bs, box, NB = Rst.shape
    dev = Rst.device
    ndof = 1
    for B, b in zip(bricks, brick_elems):
        ndof *= B * b + 1
    idx = box_index(bricks, brick_elems, dev)
    rows = (torch.arange(bs, device=dev)[:, None, None] * NB
            + torch.arange(NB, device=dev)[None, None, :]) \
        .expand(bs, box, NB)
    cols = idx[None].expand(bs, box, NB)
    vals = Rst.to(torch.float32)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    return (sparse_csr(rows, cols, vals, (bs * NB, ndof), torch),
            sparse_csr(cols, rows, vals, (ndof, bs * NB), torch))


def run_kernels(cases, torch, device_profile):
    """Each kernel against its plain version on the same card tensors,
    with its bound and, where one exists, the times of one PyTorch call
    that computes the same function; returns the kernels' records."""
    records = []
    for name, tol, source, replaces, kern, plain, work, library in cases:
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        ms = median_ms(kern, torch, draws=5, calls=20)
        dev_ms = device_ms(kern, torch, device_profile)
        h_us = host_us(kern, torch)
        plain_ms = median_ms(plain, torch, draws=5, calls=4)
        lib_ms = lib_dev_ms = None
        if library is not None:
            lib_ms = median_ms(library, torch, draws=5, calls=20)
            lib_dev_ms = device_ms(library, torch, device_profile)
        bound_ms, bound_by = bound(work)
        log("kernel", name=name, max_abs_err=f"{abs_err:.3e}",
            max_rel_err=f"{rel:.3e}", tol=tol, ms=f"{ms:.4f}",
            device_ms=f"{dev_ms:.4f}", host_us=f"{h_us:.2f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms, bytes=work[0], flops=work[1])
        if not rel <= tol:
            raise RuntimeError(f"{name}: rel err {rel:.3e} > {tol}")
        records.append({"name": name, "route": "cuda",
                        "source": f"saamge_tpu_torch/csrc/{source}",
                        "replaces": f"saamge_tpu/ops/{replaces}",
                        "max_abs_err": abs_err, "max_rel_err": rel,
                        "ms": ms, "device_ms": dev_ms, "host_us": h_us,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        "library_device_ms": lib_dev_ms})
    return records


def check_modes(name, kern, plain, modes, torch, tol=1e-5):
    """Other modes of a kernel against its plain version (rel. error and
    CUDA-event time)."""
    for mode, kw in modes:
        _, rel = rel_err(kern(mode, **kw), plain(mode, **kw))
        ms = median_ms(lambda: kern(mode, **kw), torch, draws=5, calls=20)
        log("kernel", name=f"{name}_{mode}", max_rel_err=f"{rel:.3e}",
            tol=tol, ms=f"{ms:.4f}")
        if not rel <= tol:
            raise RuntimeError(f"{name} {mode}: rel err {rel:.3e}")


def stencil_offsets(dims):
    """The 27 offsets of a Q1 stencil on a dims[0] x dims[1] x dims[2]
    node grid, rows x-major (the offsets of hex_mesh's operators)."""
    _, Y, Z = dims
    return tuple(dx * Y * Z + dy * Z + dz for dx in (-1, 0, 1)
                 for dy in (-1, 0, 1) for dz in (-1, 0, 1))


def random_dia(DIA, torch, np, rng, offsets, n, dtype, dev):
    """A diagonally dominant random DIA operator (unit centre tap), so
    that chained roots stay bounded."""
    vals = rng.uniform(-0.05, 0.05, (len(offsets), n)).astype(np.float32)
    vals[list(offsets).index(0)] = 1.0
    return DIA(torch.as_tensor(vals).to(dtype).to(dev), tuple(offsets), n)


def sweep_vectors(A, torch, np, rng, dev):
    """Haloed x, b and positive dinv of A's size."""
    x, b = (torch.as_tensor(rng.standard_normal(A.n), dtype=torch.float32)
            for _ in range(2))
    dinv = torch.as_tensor(rng.uniform(0.5, 1.0, A.n), dtype=torch.float32)
    return tuple(A.pad(v).to(dev) for v in (x, b, dinv))


def random_mfree(MatrixFreeQ1, torch, np, rng, dims, dtype, dev):
    """A matrix-free Q1 operator on a ``dims`` node grid from a numpy
    seed, diagonally dominant so that chained roots with dinv in [0.5, 1]
    stay bounded: coefficients U(0.5, 1) per element, a symmetric
    reference matrix with diagonal 1/8 and small off-diagonal values, 1 %
    essential nodes."""
    nel = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    n = dims[0] * dims[1] * dims[2]
    em0 = rng.uniform(-0.002, 0.002, (8, 8))
    em0 = em0 + em0.T + np.eye(8) / 8
    ess = rng.choice(n, max(1, n // 100), replace=False)
    op = MatrixFreeQ1.build(rng.uniform(0.5, 1.0, nel), ess, em0, dims,
                            dtype)
    return MatrixFreeQ1(op.c_h.to(dev), op.m_h.to(dev), op.K, op.dims)


def ragged_checks(dev, torch, np, k):
    """The packed mid matvec (every mode), window R and P, and the sweep
    against their plain versions on ragged shapes from a numpy seed, f32
    and bf16; each result must also repeat bit for bit.  Window P runs
    on a dense tent (every slot range [0, bs)) and on a sparse one with
    all-zero and partial slot ranges, and must equal, bit for bit, its
    own launch with the full ranges (the dense slot loop); so must
    contract P, beside contract R on its slot lists, f32 and bf16, dense
    and sparse, on (bs, box, NB) = (5, 27, 130) and (3, 125, 64); both
    must raise on the card without their slot tables.
    The sweep
    runs on odd grids, with 1, 2 and 10 roots, with and without the
    residual, and on a 7-point operator (the runtime tap count).  The
    resident mid chain runs on the same brick grids and rectangles with
    tiles of 2, 8 and 14 bricks (ragged last tiles), 1 and 4 roots, with
    and without the residual.  The matrix-free pass runs on odd node
    grids of one to three tiles a plane in every mode and must equal the
    one-thread-a-node reference bit for bit; its chain (1 and 10 roots,
    with and without the residual) must equal the kernel's own single
    passes, one a level, bit for bit.  The block-row kernel runs every
    mode its operator allows (``blockrow_ragged_cases``: groups of one
    row, groups wider than 512 columns and of more than 8 rows, one group
    alone; overlapping and disjoint column sets) and must equal
    blockrow_plain bit for bit."""
    rng = np.random.default_rng(11)
    bs = 13
    doffs = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1))
    rects = ((0, 5), (bs, bs), (3, bs)) + tuple(
        (int(a), int(b)) for a, b in rng.integers(0, bs + 1, (24, 2)))

    def vec(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(dev)

    cases = []
    for bricks in ((5, 3, 7), (6, 5, 4)):
        NB = bricks[0] * bricks[1] * bricks[2]
        x, b, dinv = vec(bs * NB), vec(bs * NB), vec(bs * NB)
        # a contracting mid chain: small d
        dmid = torch.as_tensor(rng.uniform(0.0, 0.02, bs * NB),
                               dtype=torch.float32).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            blocks = torch.zeros(len(rects), bs, bs, NB)
            for j, (r1, r2) in enumerate(rects):
                blocks[j, :r1, :r2] = torch.as_tensor(
                    rng.standard_normal((r1, r2, NB)), dtype=torch.float32)
            blocks = blocks.to(dtype).to(dev)
            for tile in (2, 8, 14):
                tiles = k["pack_tiles"](blocks, rects, tile)
                plan = k["tile_plan"](bricks, bs, rects, tile,
                                      blocks.element_size())
                for roots in (1, 4):
                    for res in (False, True):
                        a = (blocks, tiles, plan, doffs, rects, bricks,
                             (0.9, 0.6, 1.1, 0.7)[:roots], b, dmid, x, res)
                        cases.append((
                            f"mid_chain {bricks} {dtype} tile {tile} "
                            f"{roots} roots res={res}",
                            lambda a=a: k["mid_chain"](*a),
                            lambda a=(blocks,) + a[3:4] + a[5:]:
                            k["mid_chain_plain"](*a), None))
            packing = [t.to(dev) for t in k["pack_mid_blocks"](
                blocks, doffs, bricks)]
            for mode in ("spmv", "residual", "root"):
                args = (*packing, doffs, bricks, bs, x, mode, b, dinv, 0.7)
                cases.append((f"midmv {bricks} {dtype} {mode}",
                              lambda a=args: k["midmv"](*a),
                              lambda a=args: k["midmv_plain"](*a), None))
            for be in ((4, 4, 4), (8, 8, 8)):
                box = (be[0] + 1) * (be[1] + 1) * (be[2] + 1)
                nodes = [B * e + 1 for B, e in zip(bricks, be)]
                Rst = vec(bs, box, NB).to(dtype)
                r = vec(nodes[0] * nodes[1] * nodes[2])
                cases.append((f"window_R {bricks} {be} {dtype}",
                              lambda a=(Rst, r, bricks, be):
                              k["window_R"](*a),
                              lambda a=(Rst, r, bricks, be):
                              k["window_R_plain"](*a), None))
                # sparse tent: per column a random slot range, a quarter
                # of the columns all zero
                lo = torch.as_tensor(rng.integers(0, bs, (box, NB)))
                ln = torch.as_tensor(rng.integers(0, 4, (box, NB)))
                ln[torch.as_tensor(rng.random((box, NB)) < 0.25)] = 0
                s = torch.arange(bs)[:, None, None]
                keep = ((s >= lo) & (s < lo + ln)).to(dev)
                Rsp = torch.where(keep, vec(bs, box, NB), 0.0).to(dtype)
                xc = vec(bs * NB)
                full = torch.stack([torch.zeros(box, NB),
                                    torch.full((box, NB), bs)]) \
                    .to(torch.uint8).to(dev)
                for kind, R in (("dense", Rst), ("sparse", Rsp)):
                    rg = k["slot_ranges"](R)
                    a = (R, xc, bricks, be)
                    cases.append((f"window_P {bricks} {be} {dtype} {kind}",
                                  lambda a=a, rg=rg:
                                  k["window_P"](*a, ranges=rg),
                                  lambda a=a: k["window_P_plain"](*a),
                                  (lambda a=a, f=full:
                                   k["window_P"](*a, ranges=f),
                                   "its launch with the full slot ranges")))
    for cbs, cbox, cNB in ((5, 27, 130), (3, 125, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            Rst = vec(cbs, cbox, cNB)
            lo = torch.as_tensor(rng.integers(0, cbs, (cbox, cNB)))
            ln = torch.as_tensor(rng.integers(0, 4, (cbox, cNB)))
            ln[torch.as_tensor(rng.random((cbox, cNB)) < 0.25)] = 0
            s = torch.arange(cbs)[:, None, None]
            keep = ((s >= lo) & (s < lo + ln)).to(dev)
            Rsp = torch.where(keep, vec(cbs, cbox, cNB), 0.0)
            boxes, xcb = vec(cbox, cNB), vec(cbs, cNB)
            full = torch.stack([torch.zeros(cbox, cNB),
                                torch.full((cbox, cNB), cbs)]) \
                .to(torch.uint8).to(dev)
            for kind, R in (("dense", Rst.to(dtype)), ("sparse",
                                                      Rsp.to(dtype))):
                rg, sl = k["slot_ranges"](R), k["slot_lists"](R)
                what = f"{(cbs, cbox, cNB)} {dtype} {kind}"
                cases.append((f"contract_R {what}",
                              lambda a=(R, boxes), sl=sl:
                              k["contract_R"](*a, lists=sl),
                              lambda a=(R, boxes): k["contract_R_plain"](*a),
                              None))
                cases.append((f"contract_P {what}",
                              lambda a=(R, xcb), rg=rg:
                              k["contract_P"](*a, ranges=rg),
                              lambda a=(R, xcb): k["contract_P_plain"](*a),
                              (lambda a=(R, xcb), fr=full:
                               k["contract_P"](*a, ranges=fr),
                               "its launch with the full slot ranges")))
            # on the card both raise without their tables
            for name, x in (("contract_R", boxes), ("contract_P", xcb)):
                try:
                    k[name](Rst, x)
                except ValueError:
                    continue
                raise RuntimeError(f"{name} ran on the card without its "
                                   "slot table")
    DIA = k["DIA"]
    for dims in ((23, 29, 31), (17, 13, 47)):
        n = dims[0] * dims[1] * dims[2]
        taus = tuple(float(t) for t in rng.uniform(0.3, 0.9, 10))
        for dtype in (torch.float32, torch.bfloat16):
            A = random_dia(DIA, torch, np, rng, stencil_offsets(dims), n,
                           dtype, dev)
            xh, bh, dh = sweep_vectors(A, torch, np, rng, dev)
            for roots in (1, 2, 10):
                for res in (False, True):
                    a = (A, taus[:roots], bh, dh, xh, res)
                    cases.append((f"sweep {dims} {dtype} {roots} roots "
                                  f"res={res}",
                                  lambda a=a: k["wavefront"](*a),
                                  lambda a=a: k["wavefront_plain"](*a),
                                  None))
        # 7 taps: the runtime tap count
        A7 = random_dia(DIA, torch, np, rng,
                        (-dims[1] * dims[2], -dims[2], -1, 0, 1, dims[2],
                         dims[1] * dims[2]), n, torch.float32, dev)
        xh, bh, dh = sweep_vectors(A7, torch, np, rng, dev)
        a = (A7, taus, bh, dh, xh, True)
        cases.append((f"sweep {dims} 7 taps", lambda a=a: k["wavefront"](*a),
                      lambda a=a: k["wavefront_plain"](*a), None))
    mfree_h = k["mfree"]
    # the first three on the flat route; 5 x 23 x 193 (NZn > 127, tiles
    # ragged along z) and 4 x 39 x 131 (ragged along y and z) on the tiled
    routes0 = mfree_routes()
    for dims in ((13, 17, 19), (9, 29, 31), (5, 37, 41), (5, 23, 193),
                 (4, 39, 131)):
        for dtype in (torch.float32, torch.bfloat16):
            op = random_mfree(k["MatrixFreeQ1"], torch, np, rng, dims, dtype,
                              dev)
            xh, bh, dh = sweep_vectors(op, torch, np, rng, dev)
            for mode, kw in (("spmv", {}), ("residual", {"bh": bh}),
                             ("root", {"bh": bh, "dinvh": dh,
                                       "inv_tau": 0.7})):
                a = (mode, op, xh)
                cases.append((f"mfree {dims} {dtype} {mode}",
                              lambda a=a, kw=kw: mfree_h(*a, **kw),
                              lambda a=a, kw=kw: k["mfree_plain"](*a, **kw),
                              (lambda a=a, kw=kw: k["mfree_point"](*a, **kw),
                               "the one-thread-a-node reference")))
            taus = tuple(float(t) for t in rng.uniform(0.3, 0.9, 10))
            for roots in (1, 10):
                for res in (False, True):
                    a = (op, taus[:roots], bh, dh, xh, res)

                    def passes(op=op, taus=taus[:roots], res=res, xh=xh,
                               bh=bh, dh=dh):
                        x = xh
                        for it in taus:
                            x = mfree_h("root", op, x, bh, dh, it)
                        return (x, mfree_h("residual", op, x, bh)) if res \
                            else x

                    cases.append((f"mfree_chain {dims} {dtype} {roots} "
                                  f"roots res={res}",
                                  lambda a=a: k["mfree_chain"](*a),
                                  lambda a=a: k["mfree_chain_plain"](*a),
                                  (passes, "the single passes, one a level")))
    for name, sizes, m, disjoint in blockrow_ragged_cases(rng):
        M = ragged_blockrow(k["BlockRow"], sizes, m, disjoint, rng, np,
                            torch).to(dev)
        n = M.shape[0]
        modes = ["spmv"] + ["transpose"] * disjoint \
            + ["residual", "root"] * (n == m)
        for mode in modes:
            x = vec(n if mode == "transpose" else m)
            kw = {"mode": mode, "b": vec(n), "tau": 1.37,
                  "dinv": torch.as_tensor(rng.uniform(0.5, 1.0, n),
                                          dtype=torch.float32).to(dev)}
            plain = (lambda M=M, x=x, kw=kw:
                     k["blockrow_plain"](M, x, **kw))
            cases.append((f"blockrow {name} {mode}",
                          lambda M=M, x=x, kw=kw: k["blockrow"](M, x, **kw),
                          plain, (plain, "blockrow_plain")))
    worst = 0.0
    for what, kern, plain, same in cases:
        got = kern()
        again = kern()
        _, rel = rel_err(got, plain())
        worst = max(worst, rel)
        tol = 1e-4 if what.split()[0] in ("sweep", "mid_chain",
                                          "mfree_chain") else 1e-5
        if not rel <= tol:
            raise RuntimeError(f"ragged {what}: rel err {rel:.3e} > {tol}")
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise RuntimeError(f"ragged {what}: two launches differ")
        if same is not None:
            other = same[0]()
            other = other if isinstance(other, tuple) else (other,)
            if not all(torch.equal(g, o) for g, o in zip(got, other)):
                raise RuntimeError(f"ragged {what}: not bit-equal to "
                                   f"{same[1]}")
    expect_routes("ragged", routes0, ("flat", "tiled"))
    log("ragged", cases=len(cases), max_rel_err=f"{worst:.3e}",
        tol="1e-5 (sweep and chains 1e-4)", bit_reproducible=True,
        window_P_ranges_bit_equal_dense_loop=True,
        contract_P_ranges_bit_equal_full_ranges=True,
        contract_raise_without_tables=True,
        mfree_bit_equal_point_reference=True,
        mfree_chain_bit_equal_single_passes=True,
        blockrow_bit_equal_plain=True)


def blockrow_ragged_cases(rng):
    """(name, [(rows, columns)] of the groups, columns m, disjoint column
    sets) of the block-row ragged cases."""
    return (("rows1", [(1, int(c)) for c in rng.integers(1, 41, 300)],
             300, False),
            ("rows1_disjoint", [(1, int(c)) for c in rng.integers(1, 9, 300)],
             1400, True),
            ("wide", [(11, 700), (3, 520), (2, 9), (1, 1)], 1300, True),
            ("wide_square", [(4, 600)] + [(1, 7)] * 596, 600, False),
            ("one_group", [(5, 5)], 5, True))


def ragged_blockrow(BlockRow, sizes, m, disjoint, rng, np, torch):
    """An f32 BlockRow of random row groups of the given (rows, columns)
    over m columns, each group's column set drawn at random (disjoint
    ones from one permutation)."""
    import scipy.sparse as sp
    perm, at = rng.permutation(m), 0
    rows, cols, offs = [], [], [0]
    for nr, nc in sizes:
        cs = perm[at:at + nc] if disjoint else rng.choice(m, nc,
                                                          replace=False)
        at += nc
        rows.append(np.repeat(np.arange(offs[-1], offs[-1] + nr), nc))
        cols.append(np.tile(cs, nr))
        offs.append(offs[-1] + nr)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    A = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(offs[-1], m)).tocsr()
    return BlockRow.from_csr(A, np.asarray(offs), torch.float32)


def blockrow_coo(M, np):
    """(rows, columns, values) of a BlockRow's packing, on the host."""
    d = M.packed_desc.cpu().numpy().astype(np.int64)
    row0, nr, nc, voff, coff = d.T
    length = nr * nc
    g = np.repeat(np.arange(len(d)), length)
    r, c = np.divmod(np.arange(length.sum()) - voff[g], nc[g])
    return (row0[g] + r, M.packed_cols.cpu().numpy()[coff[g] + c],
            M.packed_vals.cpu().numpy())


# the block-row products of one general V-cycle: (record, level, operator,
# mode); P is the transpose of R
BLOCKROW_PRODUCTS = (("blockrow_R0", 0, "R", "spmv"),
                     ("blockrow_A1_root", 1, "A", "root"),
                     ("blockrow_A1_residual", 1, "A", "residual"),
                     ("blockrow_R1", 1, "R", "spmv"),
                     ("blockrow_P1", 1, "R", "transpose"),
                     ("blockrow_P0", 0, "R", "transpose"))


def blockrow_kernels(h, kern, torch, np, device_profile, vec):
    """The block-row kernel in each product of the general V-cycle, at
    the hierarchy's shapes, against blockrow_plain (bit for bit, and its
    repeat) and beside the CSR product of the same matrix (spmv and
    transpose).  The bound counts the packing (values, columns,
    descriptors; the uncovered columns for the transpose), the distinct
    x entries the product reads, b / dinv / x where the mode reads them,
    and the output."""
    dev = next(h.buffers()).device
    cases, pairs = [], []
    for name, level, which, mode in BLOCKROW_PRODUCTS:
        lv = h.levels[level]
        M = lv.A if which == "A" else lv.R
        n, m = M.shape
        nin, nout = (n, m) if mode == "transpose" else (m, n)
        x = vec(nin)
        kw = {"mode": mode, "b": vec(nout), "dinv": lv.dinv,
              "tau": lv.roots[0]}
        run = (lambda M=M, x=x, kw=kw: kern["blockrow"](M, x, **kw))
        ref = (lambda M=M, x=x, kw=kw: kern["blockrow_plain"](M, x, **kw))
        rows, cols, vals = blockrow_coo(M, np)
        if mode == "transpose":
            rows, cols = cols, rows
        library = None
        if mode in ("spmv", "transpose"):
            csr = sparse_csr(torch.as_tensor(rows).to(dev),
                             torch.as_tensor(cols).to(dev),
                             torch.as_tensor(vals).to(dev), (nout, nin),
                             torch)
            library = (lambda csr=csr, x=x: csr @ x[:, None])
        reads = {"spmv": len(np.unique(cols)), "transpose": n,
                 "residual": len(np.unique(cols)) + n, "root": m + 2 * n}
        mat = nbytes(M.packed_vals, M.packed_cols, M.packed_desc) + (
            nbytes(M.uncovered_cols) if mode == "transpose" else 0)
        ops = 2 * len(vals) + {"residual": n, "root": 4 * n}.get(mode, 0)
        cases.append((name, 1e-6, "blockrow.cu",
                      "blockrow.py (XLA einsum / take; no Pallas)", run, ref,
                      (mat + 4 * (reads[mode] + nout), ops), library))
        pairs += [(name, run, ref), (f"{name} repeat", run, run)]
    records = run_kernels(cases, torch, device_profile)
    for rec, (_, level, which, mode) in zip(records, BLOCKROW_PRODUCTS):
        rec.update(wrapper="blockrow", mode=mode,
                   case=f"level {level} {which}, {mode}, general n=64")
    bit_checks("blockrow", pairs, torch)
    return records


def replay_kernels(graph, torch, replays=5, lead=1000):
    """Device records of each of ``replays`` replays of ``graph`` in one
    profiler window, grouped by the correlation id of the graph launch
    (the window opens with ``lead`` small kernels that no count reads)."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device=torch.cuda.current_device())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            pad.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = {ev.correlation_id() for ev in events
                if ev.device_type() != cuda
                and ev.name().startswith(("cudaGraphLaunch",
                                          "cuGraphLaunch"))}
    counts = {}
    for ev in events:
        if ev.device_type() == cuda and ev.correlation_id() in launches:
            counts[ev.correlation_id()] = counts.get(ev.correlation_id(),
                                                     0) + 1
    return [counts[c] for c in sorted(counts)]


# the device kernel of each wrapper, as the profiler names it (the general
# path's smoother runs the sweep's device code)
KERNEL_OF = {"stencil": "stencil_kernel", "wavefront": "wavefront_kernel",
             "smoother": "wavefront_kernel", "window_R": "window_R_kernel",
             "window_P": "window_P_kernel", "mid_chain": "mid_chain_kernel",
             "mfree": "mfree_pass_kernel",
             "mfree_chain": "mfree_chain_kernel", "midmv": "midmv_kernel",
             "contract_R": "contract_R_kernel",
             "contract_P": "contract_P_kernel",
             "blockrow": "blockrow_kernel",
             "vstencil_chain": "vstencil_chain_kernel",
             "vstencil_spmv": "vstencil_pass_kernel",
             "vstencil_residual": "vstencil_pass_kernel",
             "symv": "symv_tile_kernel"}
# the utils/logging.TIMERS counter of each wrapper's launches (the table
# of ops/__init__.py); a wrapper with modes counts each as
# ``<wrapper>.kernel.<mode>``, and its launches are their sum
COUNTER_OF = {"stencil": "stencil.kernel", "wavefront": "wavefront.kernel",
              "smoother": "smoother.kernel", "window_R": "window.kernel.R",
              "window_P": "window.kernel.P", "mid_chain": "midsmooth.kernel",
              "mfree_chain": "mfree.kernel.chain",
              "contract_R": "contract.kernel.R",
              "contract_P": "contract.kernel.P",
              "vstencil_chain": "vstencil.kernel.chain",
              "vstencil_spmv": "vstencil.kernel.spmv",
              "vstencil_residual": "vstencil.kernel.residual",
              "symv": "symv.kernel"}
VSTENCIL = ("vstencil_chain", "vstencil_spmv", "vstencil_residual")
MODES_OF = {"mfree": ("spmv", "residual", "root"),
            "midmv": ("spmv", "residual", "root"),
            "blockrow": ("spmv", "residual", "root", "transpose")}


def launch_counts(before):
    """(launches by wrapper, launches by mode of each wrapper with modes)
    since ``before``, a copy of the TIMERS counters."""
    from saamge_tpu_torch.utils.logging import TIMERS

    def grown(k):
        return TIMERS.counters.get(k, 0) - before.get(k, 0)
    modes = {w: {m: grown(f"{w}.kernel.{m}") for m in ms}
             for w, ms in MODES_OF.items()}
    launches = {w: grown(k) for w, k in COUNTER_OF.items()}
    launches.update((w, sum(m.values())) for w, m in modes.items())
    return launches, modes


def kernel_records(solve, torch, device_profile, windows=3, lead=1000):
    """(device kernel records of the port's kernels by kernel name,
    ``solve()``'s result) of one ``solve()`` in one torch.profiler window
    (taken again when the profiler delivered no kernel record, up to
    ``windows`` times).  The profiler can lose the first device records
    of a window, more of them the more the process has profiled (seen: a
    twolevel window that missed the solve's first sweep and window R in
    five windows in a row, its last kernels all there), so each window
    opens with ``lead`` small kernels of its own that no count reads."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device=torch.cuda.current_device())
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1.0)
            torch.cuda.synchronize()
            result = solve()
            torch.cuda.synchronize()
        _, _, by_name = device_profile(prof, torch)
        if by_name:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device kernel in "
                           f"{windows} windows")
    counts = dict.fromkeys(sorted(set(KERNEL_OF.values())), 0)
    for name, (calls, _) in by_name.items():
        for k in counts:
            if re.search(rf"\b{k}\b", name):
                counts[k] += calls
    return counts, result


def agree(path, what, got, ref, exact, torch):
    """Raise unless ``got`` equals ``ref`` bit for bit (``exact``) or
    within 1e-5 relative; returns the relative error."""
    _, rel = rel_err(got, ref)
    if exact and not torch.equal(got, ref):
        raise RuntimeError(f"{path} {what}: not bit-equal (rel err "
                           f"{rel:.3e})")
    if not rel <= 1e-5:
        raise RuntimeError(f"{path} {what}: rel err {rel:.3e} > 1e-5")
    return rel


def run_slice(path, h, h_cpu, b_np, A_host, torch, np, vcycle, pcg,
              device_profile, exact=True, cpu_pcg=True, cpu_tol=1e-4):
    """The V-cycle on the card (its captured graph, the default) vs the
    CPU copy and vs the eager cycle; PCG at both tolerances by both
    loops, the eager loop (``graph=False``) first, with the launch
    counts of every wrapper during its 1e-6 solve; the graph loop's
    kernel records from the profiler, which must equal those counts;
    both loops' times and peak device memory; a second right-hand side
    through the same graphs against its eager solve; the CPU copy's 1e-6
    PCG within one iteration (unless ``cpu_pcg`` is False).  The card's
    V-cycle must agree with the CPU copy's within ``cpu_tol``.  ``exact``:
    graph and eager must agree bit for bit (the structured paths), else
    within 1e-5 relative and one iteration (the general path's
    index_add_).  The result holds the card's V-cycle (on the CPU) as
    ``vcycle``."""
    from saamge_tpu_torch.utils.logging import TIMERS
    dev = next(h.buffers()).device
    b = torch.as_tensor(b_np, dtype=torch.float32)
    bd = b.to(dev)
    yg = vcycle(h, bd)
    _, rel = rel_err(yg.cpu(), vcycle(h_cpu, b))
    v_rel = agree(path, "V-cycle graph vs eager", yg,
                  vcycle(h, bd, graph=False), exact, torch)
    log(path, vcycle_vs_cpu_rel_err=f"{rel:.3e}", tol=cpu_tol,
        vcycle_graph_vs_eager_rel_err=f"{v_rel:.3e}",
        at_s=f"{time.perf_counter() - T0:.1f}")
    if not rel <= cpu_tol:
        raise RuntimeError(f"{path}: V-cycle card vs CPU rel err {rel:.3e}")

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    before = dict(TIMERS.counters)
    _, it6, _ = pcg(h, bd, 1e-6, graph=False)
    torch.cuda.synchronize()
    launches, modes = launch_counts(before)
    log(path, launches=launches, launches_by_mode=modes)

    loops = {}
    for loop in ("eager", "graph"):
        graph = loop == "graph"
        t0 = time.perf_counter()
        _, it6l, _ = pcg(h, bd, 1e-6, graph=graph)
        torch.cuda.synchronize()
        pcg6_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        x8, it8, _ = pcg(h, bd, 1e-8, graph=graph)
        torch.cuda.synchronize()
        pcg8_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        peak_res = torch.cuda.max_memory_reserved(dev)
        vms = median_ms(lambda: vcycle(h, bd, graph=graph), torch, draws=20,
                        calls=1)
        loops[loop] = {"x8": x8, "it": (it6l, it8), "out": {
            "pcg_iters_1e6": it6l, "pcg_iters_1e8": it8,
            # the graph loop's first 1e-6 solve captures its graphs
            ("pcg_1e6_first_s" if graph else "pcg_1e6_s"): f"{pcg6_s:.3f}",
            "pcg_1e8_s": f"{pcg8_s:.3f}",
            "pcg_1e8_ms_per_iter": f"{pcg8_s * 1e3 / max(it8, 1):.4f}",
            "vcycle_ms": f"{vms:.4f}",
            "dofs_per_s": f"{h.n / (vms / 1e3):.4e}",
            "peak_bytes_pcg": peak, "peak_reserved_bytes_pcg": peak_res}}
        log(path, loop=loop, **loops[loop]["out"])
    eager, graph = loops["eager"], loops["graph"]
    it8 = graph["it"][1]
    if it6 != eager["it"][0]:
        raise RuntimeError(f"{path}: eager PCG {it6} then {eager['it'][0]} "
                           "iterations at 1e-6")
    slack = 0 if exact else 1
    for tol, a, c in zip(TOLS, eager["it"], graph["it"]):
        if abs(a - c) > slack:
            raise RuntimeError(f"{path}: graph PCG {c} vs eager {a} "
                               f"iterations at {tol}")
    x_rel = agree(path, "PCG x graph vs eager", graph["x8"], eager["x8"],
                  exact and eager["it"] == graph["it"], torch)

    # the graph loop's kernels, counted on the device: each must run as
    # often as the eager loop launched it.  The profiler drops device
    # records now and then (seen: six of the contract path's 38 sweep
    # records in one window; beside the loss at a window's start that
    # kernel_records absorbs), so a window that disagrees is taken again,
    # up to five; a graph that really differs disagrees in every window.
    expect = dict.fromkeys(sorted(set(KERNEL_OF.values())), 0)
    for name, n in launches.items():
        expect[KERNEL_OF[name]] += n
    for window in range(1, 6):
        records, (_, itp, _) = kernel_records(lambda: pcg(h, bd, 1e-6),
                                              torch, device_profile)
        log(path, graph_kernel_records=records, eager_launches=expect,
            iterations=(itp, it6), window=window)
        if itp == it6 and records == expect:
            break
    if (records != expect if itp == it6 else
            any((records[k] > 0) != (expect[k] > 0) for k in records)):
        raise RuntimeError(f"{path}: graph PCG kernel records {records} vs "
                           f"eager launches {expect} ({itp} vs {it6} "
                           "iterations)")

    # a second right-hand side through the same graphs
    b2 = torch.as_tensor(np.random.default_rng(1).standard_normal(h.n),
                         dtype=torch.float32, device=dev)
    x2g, it2g, _ = pcg(h, b2, 1e-8)
    x2e, it2e, _ = pcg(h, b2, 1e-8, graph=False)
    if abs(it2g - it2e) > slack:
        raise RuntimeError(f"{path}: second rhs, graph PCG {it2g} vs eager "
                           f"{it2e} iterations")
    x2_rel = agree(path, "second rhs x graph vs eager", x2g, x2e,
                   exact and it2g == it2e, torch)
    log(path, second_rhs_iters=(it2g, it2e), second_rhs_rel_err=x2_rel,
        pcg_x_graph_vs_eager_rel_err=f"{x_rel:.3e}")

    it6_cpu = pcg(h_cpu, b, 1e-6)[1] if cpu_pcg else None
    x8 = graph["x8"]
    xs = x8.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_np - A_host @ xs)
                     / np.linalg.norm(b_np))
    finite = bool(torch.isfinite(x8).all()) and x8.shape == (h.n,)
    out = {"pcg_iters_1e6_cpu": it6_cpu,
           "true_rel_res_1e8": f"{true_res:.3e}",
           "buffer_bytes": buffer_bytes(h), "resident_bytes": resident}
    log(path, **out)
    if not finite:
        raise RuntimeError(f"{path}: PCG solution is not finite or has the "
                           "wrong shape")
    if cpu_pcg and abs(it6 - it6_cpu) > 1:
        raise RuntimeError(f"{path}: card PCG {it6} vs CPU PCG {it6_cpu} "
                           "iterations")
    if not true_res <= 1e-3:
        raise RuntimeError(f"{path}: true relative residual {true_res:.3e}")
    out.update(graph["out"], eager=eager["out"], launches=launches,
               modes=modes, it=(graph["it"][0], it8), vcycle=yg.cpu())
    return out


# f32 operations of one matrix-free pass a node, as the function does them:
# 64 FMAs rebuild the 27 values from the 8 c values, one multiply forms
# x * m, 27 FMAs sum the taps, 5 the mask's epilogue
# m * acc + (1 - m) * (val13 * x), then the mode's own.
MFREE_NODE_FLOPS = 2 * 64 + 1 + 2 * 27 + 5
MFREE_MODE_FLOPS = {"spmv": 0, "residual": 1, "root": 4}


def mfree_flops(nodes, roots=0, residual=False, spmv=False) -> int:
    """f32 operations of ``roots`` root passes, then a residual and / or
    an spmv pass, over ``nodes`` nodes."""
    modes = ["root"] * roots + ["residual"] * residual + ["spmv"] * spmv
    return sum(MFREE_NODE_FLOPS + MFREE_MODE_FLOPS[m] for m in modes) * nodes


def mfree_passes(mfree_h, op, inv_taus, bh, dinvh, xh, emit_res):
    """The chain as the kernel's own single passes, one a level."""
    for it in inv_taus:
        xh = mfree_h("root", op, xh, bh, dinvh, it)
    return (xh, mfree_h("residual", op, xh, bh)) if emit_res else xh


def mfree_routes():
    """The counters of the matrix-free kernel's two routes."""
    from saamge_tpu_torch.utils.logging import TIMERS
    return {r: TIMERS.counters.get(f"mfree.route.{r}", 0)
            for r in ("tiled", "flat")}


def expect_routes(phase, before, routes):
    """Log the routes' launches since ``before``; raise unless each of
    ``routes`` (None: any) ran and no other did."""
    now = mfree_routes()
    ran = {r: now[r] - before[r] for r in now}
    log(phase, mfree_routes=ran)
    if routes is not None and any((ran[r] > 0) != (r in routes)
                                  for r in ran):
        raise RuntimeError(f"{phase}: mfree routes {ran}, expected only "
                           f"{routes}")


def bit_checks(phase, pairs, torch):
    """Each (name, kernel, other) pair must agree bit for bit."""
    for name, kern, other in pairs:
        a, b = kern(), other()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"{phase} {name}: not bit-equal")
    log(phase, bit_equal=[name for name, _, _ in pairs])


def capacity_bit_checks(k, torch, np, dev, dims=(193, 193, 193)):
    """The capacity phase's bit checks of the matrix-free pass and chain
    on a random operator at the capacity cell's node grid (n=192): the
    pass in every mode (f32 c/m for spmv, bf16 for residual and root)
    against the one-thread-a-node reference, the chain (10 roots +
    residual, bf16) against its own single passes."""
    rng = np.random.default_rng(192)
    ops = {dt: random_mfree(k["MatrixFreeQ1"], torch, np, rng, dims, dt, dev)
           for dt in (torch.float32, torch.bfloat16)}
    op32, op16 = ops[torch.float32], ops[torch.bfloat16]
    xh, bh, dh = sweep_vectors(op32, torch, np, rng, dev)
    taus = tuple(float(t) for t in rng.uniform(0.3, 0.9, 10))
    chain = (op16, taus, bh, dh, xh, True)
    routes0 = mfree_routes()
    bit_checks(f"capacity {dims}", [
        (f"mfree {mode}", lambda op=op, mode=mode, kw=kw:
         k["mfree"](mode, op, xh, **kw),
         lambda op=op, mode=mode, kw=kw: k["mfree_point"](mode, op, xh, **kw))
        for mode, op, kw in (("spmv", op32, {}),
                             ("residual", op16, {"bh": bh}),
                             ("root", op16, {"bh": bh, "dinvh": dh,
                                             "inv_tau": 0.7}))]
        + [("mfree_chain", lambda: k["mfree_chain"](*chain),
            lambda: mfree_passes(k["mfree"], *chain))], torch)
    expect_routes(f"capacity {dims}", routes0, ("tiled",))


def fmt(M):
    """A device matrix's format name (a block-row one with its buckets)."""
    nb = getattr(getattr(M, "base", M), "nbuckets", None)
    return type(M).__name__ + (f"[{nb} buckets]" if nb else "")


def random_node_block(NodeBlock, torch, np, rng, dims, k, dev):
    """A diagonally dominant random node-block operator on a ``dims``
    node grid: the first ``k`` of the grid's 27 node offsets (the centre
    among them), blocks U(-0.01, 0.01) and the centre block the identity
    plus them, so that chained roots with dinv in [0.5, 1] stay bounded."""
    offs = stencil_offsets(dims)
    offs = sorted(set(offs[:k - 1]) | {0})
    N = dims[0] * dims[1] * dims[2]
    vals = rng.uniform(-0.01, 0.01, (len(offs), 3, 3, N))
    vals[offs.index(0)] += np.eye(3)[:, :, None]
    return NodeBlock(torch.as_tensor(vals, dtype=torch.float32).to(dev),
                     offs)


def vstencil_ragged(dev, torch, np, kern):
    """The node-block kernel in each mode on ragged node grids (27 and 7
    offsets; chains of 1, 10 and 33 roots -- two launches --, with and
    without the residual), bit for bit against vstencil_plain on the
    same card tensors; returns the number of cases."""
    vstencil, plain = kern["vstencil"], kern["vstencil_plain"]
    rng = np.random.default_rng(11)
    cases = 0
    for dims, k in (((13, 17, 19), 27), ((9, 29, 31), 27), ((5, 7, 11), 7)):
        A = random_node_block(kern["NodeBlock"], torch, np, rng, dims, k,
                              dev)

        def vec(lo, hi):
            v = torch.as_tensor(rng.uniform(lo, hi, A.n),
                                dtype=torch.float32)
            return A.pad(v).to(dev)
        xh, bh, dh = vec(-1, 1), vec(-1, 1), vec(0.5, 1.0)
        runs = [("spmv", {}), ("residual", dict(bh=bh))]
        for roots in (1, 10, 33):
            taus = tuple(float(np.float32(t)) for t in
                         rng.uniform(0.5, 1.5, roots))
            for res in (False, True):
                runs.append(("chain", dict(bh=bh, dinvh=dh, inv_taus=taus,
                                           emit_residual=res)))
        for mode, kw in runs:
            got = vstencil(A, mode, xh, **kw)
            ref = plain(A, mode, xh, **kw)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                _, rel = rel_err(got, ref)
                raise RuntimeError(f"vstencil {mode} {dims} k={k} "
                                   f"{len(kw.get('inv_taus', ()))} roots: "
                                   f"not bit-equal (rel err {rel:.3e})")
            cases += 1
    log("ragged", vstencil_cases=cases, bit_equal=True)
    return cases


def elasticity_kernels(e, A_fine, kern, torch, device_profile, vec):
    """The node-block kernel's three modes at the finest elasticity
    level's own shapes against vstencil_plain, each beside the plain ELL
    product (or chain) of the same level as its library call."""
    from saamge_tpu_torch.ops.sparse import ELL
    vstencil, plain = kern["vstencil"], kern["vstencil_plain"]
    lv = e.levels[0]
    E = lv.A
    dev = E.vals.device
    ell = ELL.from_csr(A_fine, torch.float32).to(dev)
    replaces = "sparse.py (ELL, left to XLA; no Pallas)"
    x, b = vec(E.n), vec(E.n)
    xh, bh = E.pad(x), E.pad(b)
    hvec = 3 * (E.nodes + 2 * E.halo)
    nnz = int(A_fine.count_nonzero())
    roots = len(lv.inv_taus)

    def ell_chain():
        y = x
        for tau in lv.roots:
            y = y + (lv.dinv * (b - ell.matvec(y))) / tau
        return y, b - ell.matvec(y)

    chain = dict(bh=bh, dinvh=lv.dinvh, inv_taus=lv.inv_taus,
                 emit_residual=True)
    recs = run_kernels([
        ("vstencil_chain", 1e-6, "vstencil.cu", replaces,
         lambda: vstencil(E, "chain", xh, **chain),
         lambda: plain(E, "chain", xh, **chain),
         (nbytes(E.vals) + 5 * hvec * 4, 2 * nnz * (roots + 1)), ell_chain),
        ("vstencil_spmv", 1e-6, "vstencil.cu", replaces,
         lambda: vstencil(E, "spmv", xh), lambda: plain(E, "spmv", xh),
         (nbytes(E.vals) + 2 * hvec * 4, 2 * nnz),
         lambda: ell.matvec(x)),
        ("vstencil_residual", 1e-6, "vstencil.cu", replaces,
         lambda: vstencil(E, "residual", xh, bh),
         lambda: plain(E, "residual", xh, bh),
         (nbytes(E.vals) + 3 * hvec * 4, 2 * nnz),
         lambda: b - ell.matvec(x)),
    ], torch, device_profile)
    for rec in recs:
        rec["case"] = (f"f32 3x3 node blocks, 27 offsets, {E.nodes} nodes, "
                       f"{roots} roots + residual, beside the ELL level")
    return recs


def symv_kernels(name, h, Ac, kern, torch, device_profile, vec):
    """The coarsest product (csrc/symv.cu) at a general hierarchy's own
    coarsest level against symv_plain (bit for bit, and its repeat),
    beside two yardsticks the port never calls: torch's product with the
    dense inverse (the record's library times) and the pair of triangular
    solves with the Cholesky factor of ``Ac`` that the kernel replaced
    (``trsv_ms``, ``trsv_device_ms``), both in the tiles' dtype; and the
    device time of each of its two launches.  The bound counts the
    n (n + 1) / 2 values of one triangle, x and y; the log gives the
    bytes the tiles store (the diagonal tiles whole, the last tile row
    padded) apart."""
    tiles, n = h.coarse_inv, h.coarse_n
    dev, T = tiles.device, tiles.shape[-1]
    nt = kern["symv_tile_rows"](n)
    I, J = torch.tril_indices(nt, nt, device=dev)
    D = torch.zeros(nt, nt, T, T, dtype=tiles.dtype, device=dev)
    D[I, J] = tiles
    D[J, I] = tiles.mT
    dense = D.permute(0, 2, 1, 3).reshape(nt * T, nt * T)[:n, :n] \
        .contiguous()
    del D
    L = torch.linalg.cholesky(torch.as_tensor(Ac.toarray()).to(dev)) \
        .to(tiles.dtype)
    x = vec(n)

    def run():
        return kern["symv"](tiles, x)

    def ref():
        return kern["symv_plain"](tiles, x)

    def trsv():
        y = torch.linalg.solve_triangular(L, x[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    rec = run_kernels([
        (name, 1e-6, "symv.cu", "../solve/compiled.py coarse_solve "
         "(solve_triangular twice; no Pallas)", run, ref,
         ((n * (n + 1) // 2 + 2 * n) * tiles.element_size(), 2 * n * n),
         lambda: dense @ x),
    ], torch, device_profile)[0]
    _, vs_trsv = rel_err(run(), trsv())
    rec.update(wrapper="symv", trsv_ms=median_ms(trsv, torch, draws=5,
                                                 calls=20),
               trsv_device_ms=device_ms(trsv, torch, device_profile),
               vs_trsv_rel_err=vs_trsv,
               case=f"{tiles.dtype} lower tiles of the coarsest inverse, "
                    f"{n} dofs, {tiles.shape[0]} tiles of {T}^2")
    log("kernel", name=f"{name}_yardsticks", trsv_ms=f"{rec['trsv_ms']:.4f}",
        trsv_device_ms=f"{rec['trsv_device_ms']:.4f}",
        vs_trsv_rel_err=f"{vs_trsv:.3e}", tiles_bytes=nbytes(tiles))
    log("kernel", name=f"{name}_stages", calls=20,
        device_us_records={k: (round(us, 3), c) for k, (us, c) in
                           stage_us(run, torch, device_profile).items()})
    bit_checks(name, [(name, run, ref), (f"{name} repeat", run, run)],
               torch)
    return [rec]


def stage_us(fn, torch, device_profile, calls=20):
    """(Mean device us per call, records) of each kernel that ``fn``
    launches, by kernel name; fewer records than ``calls`` means the
    profiler dropped some, and the mean reads low."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, _, by_name = device_profile(prof, torch)
    return {k: (t / calls, c) for k, (c, t) in by_name.items()}


def coarse_checks(path, h, bd, it_e, vcycle, device_profile, torch,
                  before):
    """The coarsest solve of ``path``'s eager 1e-6 PCG of ``it_e``
    iterations (counters since ``before``): one launched product a
    V-cycle, no plain route; and no triangular solve among the device
    kernels of one profiled eager V-cycle."""
    from torch.profiler import ProfilerActivity, profile
    from saamge_tpu_torch.utils.logging import TIMERS
    routes = {k: TIMERS.counters.get(k, 0) - before.get(k, 0)
              for k in ("symv.kernel", "symv.plain")}
    vcycle(h, bd, graph=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vcycle(h, bd, graph=False)
        torch.cuda.synchronize()
    _, _, by_name = device_profile(prof, torch)
    trsv = sorted(k for k in by_name if "trsv" in k or "trsm" in k)
    log(path, symv_routes=routes, symv_products_per_vcycle=1,
        vcycle_device_kernels=sum(c for c, _ in by_name.values()),
        triangular_solve_kernels=trsv)
    if routes["symv.plain"] or routes["symv.kernel"] != it_e + 1 or trsv:
        raise RuntimeError(f"{path} coarsest solve: routes {routes} in "
                           f"{it_e} iterations (one product a V-cycle "
                           f"expected), triangular solves {trsv}")


def check_launches(path, launches, must, never):
    low = {k: launches[k] for k in must if launches[k] < 1}
    high = {k: launches[k] for k in never if launches[k] > 0}
    if low or high:
        raise RuntimeError(f"{path} PCG launches: not launched {low}, "
                           f"launched but must not be {high}")


def twolevel_compile(ml, geo, dev, torch, np, compile_structured):
    """Phase 3c: the two-level hierarchy of the flagship setup (its level
    0 only: the coarsest level is the flagship's mid level, 18,917 dofs at
    n=96), compiled on the card, whose coarsest inverse then takes the
    Cholesky route; the inverse's seconds (timer
    ``compile.coarsest_inverse``) and the compile's peak device bytes.
    Beside it the JAX rounding of the small-size route: the f64 inverse
    (Cholesky and cholesky_inverse in f64 on the card) rounded to f32.
    Returns (the hierarchy, moved to the CPU; the f32-rounded f64
    inverse, on the CPU)."""
    from saamge_tpu_torch.utils.logging import TIMERS
    ml2 = copy.copy(ml)
    ml2.levels = ml.levels[:1]
    TIMERS.totals.pop("compile.coarsest_inverse", None)
    leave_card(torch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    h2 = compile_structured(ml2, geo, device=dev)
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    inv_s = TIMERS.totals.get("compile.coarsest_inverse")
    nc = int(h2.Ainv.shape[0])
    if inv_s is None:
        raise RuntimeError(f"twolevel: the coarsest inverse ({nc} dofs) did "
                           "not take the card's Cholesky route")
    t0 = time.perf_counter()
    L = torch.linalg.cholesky(torch.as_tensor(
        np.asarray(ml2.levels[0].tg_data.Ac.todense(), np.float64)).to(dev))
    ref = torch.cholesky_inverse(L).to(torch.float32)
    del L
    torch.cuda.synchronize(dev)
    ref_s = time.perf_counter() - t0
    diff = float((h2.Ainv - ref).abs().max() / ref.abs().max())
    log("twolevel setup", coarsest_dofs=nc, inverse_s=f"{inv_s:.3f}",
        compile_s=f"{compile_s:.2f}", compile_peak_device_bytes=peak,
        ainv_bytes=nbytes(h2.Ainv), f64_inverse_s=f"{ref_s:.3f}",
        inverse_vs_f64_rel_diff=f"{diff:.3e}")
    out = h2.to("cpu"), ref.cpu()
    del h2, ref
    leave_card(torch)
    return out


def rap_check(path, ml, geo, dev, torch):
    """The device Galerkin product (setup/device_rap.py) of ``ml``'s level
    0 on the card against the host f64 product P^T A P (tg_coarse_matr of
    the tent P, timed here): within 1e-5 of max |Ac| and the same nnz.
    Logs both seconds (the device phase's split into the block
    contractions and the host CSR assembly), bs, the peak device bytes
    and the bytes reckoned from the shapes.  Returns (device Ac, host
    Ac)."""
    from saamge_tpu_torch.setup.device_rap import structured_rap
    from saamge_tpu_torch.setup.tg import tg_coarse_matr
    from saamge_tpu_torch.utils.logging import TIMERS
    lv0 = ml.levels[0]
    tg0 = lv0.tg_data
    t0 = time.perf_counter()
    Ac_host = tg_coarse_matr(lv0.A, tg0.tent_interp)
    host_s = time.perf_counter() - t0
    leave_card(torch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    phases = ("setup.rap_device", "setup.rap_device.blocks",
              "setup.rap_device.csr")
    before = {k: TIMERS.total(k) for k in phases}
    stats = {}
    Ac = structured_rap(lv0.A, lv0.rels, tg0.tent_interp,
                        tg0.interp_data.mis_numcoarsedof, geo, device=dev,
                        stats=stats)
    split = {k: round(TIMERS.total(k) - before[k], 3) for k in phases}
    peak = torch.cuda.max_memory_allocated(dev) - base
    bs, NB = stats["bs"], geo.num_bricks
    ext = 1
    for b in geo.brick_elems:
        ext *= b + 3
    reckoned = {"APq": 4 * bs * ext * NB, "rst6": 4 * bs * geo.box * NB,
                "blocks": 4 * 27 * bs * bs * NB}
    diff = float(abs(Ac - Ac_host).max())
    scale = float(abs(Ac_host).max())
    log(path + " rap", device_s=json.dumps(split), host_s=f"{host_s:.3f}",
        bs=bs, coarse_dofs=Ac.shape[0], nnz=Ac.nnz, host_nnz=Ac_host.nnz,
        rel_diff=f"{diff / scale:.3e}", peak_device_bytes=peak,
        reckoned_bytes=json.dumps(reckoned),
        blocks_bytes=stats["blocks_bytes"])
    if not diff <= 1e-5 * scale or Ac.nnz != Ac_host.nnz:
        raise RuntimeError(f"{path}: device RAP {diff / scale:.3e} of max "
                           f"|Ac| off the host product, nnz {Ac.nnz} vs "
                           f"{Ac_host.nnz}")
    leave_card(torch)
    return Ac, Ac_host


def assembly_check(n, dev, torch, np, seed=7, contrast=2.0):
    """The device element matrices (fem/assemble_device.py) of
    ``hex_mesh(n)`` with the flagship's coefficients on the card against
    the host f64 batch (fem/assemble.py): within 1e-5 of its max; logs
    elements/s of both (the device's after a warm-up call, transfers
    included)."""
    from saamge_tpu_torch.fem import assemble, assemble_device
    from saamge_tpu_torch.fem.mesh import hex_mesh
    mesh = hex_mesh(n)
    ne = mesh.num_elements
    coefs = 10.0 ** np.random.default_rng(seed).uniform(-contrast, contrast,
                                                        ne)
    assemble_device.diffusion_element_matrices(hex_mesh(4), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    em_d = assemble_device.diffusion_element_matrices(mesh, coefs,
                                                      device=dev)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    em_h = assemble.diffusion_element_matrices(mesh, coefs)
    host_s = time.perf_counter() - t0
    rel = float(np.abs(em_d - em_h).max() / np.abs(em_h).max())
    log("assembly", elements=ne, device_s=f"{dev_s:.3f}",
        device_elements_per_s=f"{ne / dev_s:.4e}", host_s=f"{host_s:.3f}",
        host_elements_per_s=f"{ne / host_s:.4e}", rel_err=f"{rel:.3e}")
    if not rel <= 1e-5:
        raise RuntimeError(f"device element matrices {rel:.3e} off the host")


def scale_kernels(h, geo, kern, torch, np, dev):
    """Each kernel of the scale path against its plain version on the
    card at the scale hierarchy's own shapes (its operators and tent
    blocks, vectors from a numpy seed), within the kernel phase's
    tolerances: the stencil's spmv (the PCG operator), the sweep, window
    R and P, and the packed mid passes in the modes the V-cycle runs
    (residual, root), or the resident mid chain.  Untimed; these launches
    fall before the path's counts are reset."""
    rng = np.random.default_rng(5)

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m),
                               dtype=torch.float32).to(dev)

    A0, A0s = h.A0, h.A0s
    xh, bh = A0.pad(vec(h.n)), A0.pad(vec(h.n))
    r_f, xc, x1, b1 = vec(h.n), vec(h.n_flat), vec(h.n_flat), vec(h.n_flat)
    ga = (geo.bricks, geo.brick_elems)
    sweep = (A0s, h.taus0, bh, h.dinv0h, xh, True)
    cases = [
        ("stencil spmv", 1e-5, lambda: kern["stencil"]("spmv", A0, xh),
         lambda: kern["stencil_plain"]("spmv", A0, xh)),
        ("wavefront", 1e-4, lambda: kern["wavefront"](*sweep),
         lambda: kern["wavefront_plain"](*sweep)),
        ("window_R", 1e-5, lambda: kern["window_R"](h.Rst, r_f, *ga),
         lambda: kern["window_R_plain"](h.Rst, r_f, *ga)),
        ("window_P", 1e-5,
         lambda: kern["window_P"](h.Rst, xc, *ga, ranges=h.Rst_rng),
         lambda: kern["window_P_plain"](h.Rst, xc, *ga))]
    if h.mid_route == "packed":
        mv = (h.A1_packed, h.A1_index, h.doffs, geo.bricks, h.bs, x1)
        for mode, kw in (("residual", {"b": b1}),
                         ("root", {"b": b1, "dinv": h.dinv1,
                                   "inv_tau": h.taus1[0]})):
            cases.append((f"midmv {mode}", 1e-5,
                          lambda mode=mode, kw=kw: kern["midmv"](*mv, mode,
                                                                 **kw),
                          lambda mode=mode, kw=kw: kern["midmv_plain"](
                              *mv, mode, **kw)))
    else:
        chain = (h.A1_blocks, h.A1_tiles, h.mid_plan, h.doffs, h.rects,
                 geo.bricks, h.taus1, b1, h.dinv1, x1, True)
        cases.append(("mid_chain", 1e-4, lambda: kern["mid_chain"](*chain),
                      lambda: kern["mid_chain_plain"](
                          h.A1_blocks, h.doffs, geo.bricks, h.taus1, b1,
                          h.dinv1, x1, True)))
    errs = {}
    for name, tol, kf, pf in cases:
        abs_err, rel = rel_err(kf(), pf())
        errs[name] = rel
        log("scale kernel", name=name, bricks=geo.num_bricks,
            max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel:.3e}", tol=tol)
        if not rel <= tol:
            raise RuntimeError(f"scale {name}: rel err {rel:.3e} > {tol} "
                               f"at {geo.num_bricks} bricks")
    return errs


def scale_path(n, brick, dev, kern, torch, np, vcycle, pcg, device_profile):
    """Phase 10: the scale-setup driver at ``n`` with the device RAP and
    the solve on the card; the setup's device Ac against the host
    product and, bit for bit, a second device product; the path's
    kernels against their plain versions at the hierarchy's shapes; the
    slice of the driver's hierarchy against its CPU copy."""
    from saamge_tpu_torch.drivers import run_scale_setup
    from saamge_tpu_torch.solve.structured import BrickGeometry
    leave_card(torch)
    t0 = time.perf_counter()
    out, run = run_scale_setup.run(["--n", str(n), "--brick", str(brick),
                                    "--device-rap", "--solve"])
    log("scale", driver_s=f"{time.perf_counter() - t0:.1f}",
        driver=json.dumps(out))
    if not (out["device_rap"] and out["rap"].get("bs", 0) > 0):
        raise RuntimeError("scale: the setup did not take the device RAP")
    nb = n // brick
    geo = BrickGeometry((nb,) * 3, (brick,) * 3)
    Ac_dev, Ac_host = rap_check("scale", run.ml, geo, dev, torch)
    setup_Ac = run.ml.levels[0].tg_data.Ac
    scale = float(abs(Ac_host).max())
    d_host = float(abs(setup_Ac - Ac_host).max()) / scale
    same = (setup_Ac != Ac_dev).nnz == 0 and setup_Ac.nnz == Ac_dev.nnz
    log("scale", setup_ac_vs_host_rel_diff=f"{d_host:.3e}",
        setup_ac_bit_equal_device=same, setup_ac_nnz=setup_Ac.nnz)
    if not (d_host <= 1e-5 and same and setup_Ac.nnz == Ac_host.nnz):
        raise RuntimeError(f"scale: the setup's Ac {d_host:.3e} off the "
                           f"host product, bit-equal to the device "
                           f"product: {same}")
    del Ac_dev, Ac_host, setup_Ac
    h = run.h
    scale_kernels(h, geo, kern, torch, np, dev)
    leave_card(torch)
    t0 = time.perf_counter()
    h_cpu = copy.deepcopy(h).to("cpu")
    log("scale", cpu_copy_s=f"{time.perf_counter() - t0:.1f}")
    res = run_slice("scale", h, h_cpu, run.b, run.ml.levels[0].A, torch,
                    np, vcycle, pcg, device_profile)
    del h_cpu
    mid = "mid_chain" if h.mid_route == "resident" else "midmv"
    check_launches("scale", res["launches"],
                   ("stencil", "wavefront", "window_R", "window_P", mid),
                   ("mfree", "mfree_chain", "smoother", "contract_R",
                    "contract_P", {"mid_chain": "midmv",
                                   "midmv": "mid_chain"}[mid]))
    if res["it"][0] != out["pcg_iters"]:
        raise RuntimeError(f"scale: slice PCG {res['it'][0]} vs the driver's "
                           f"{out['pcg_iters']} iterations at 1e-6")
    limits = SCALE_PCG_MAX.get(n, {})
    log("scale", mid_route=h.mid_route, pcg_iters=res["it"],
        pcg_limits=json.dumps(limits), driver_vcycle_ms=out["vcycle_ms"],
        driver_pcg_iters=out["pcg_iters"])
    for tol, it in zip(TOLS, res["it"]):
        if it > limits.get(tol, it):
            raise RuntimeError(f"scale n={n}: PCG {it} iterations at {tol} "
                               f"above {limits[tol]}")
    return res


def leave_card(torch):
    """Collect garbage and empty the allocator's cache; logs the bytes
    allocated on the card before and after the collection (what only a
    cyclic collection would have freed)."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    log("leave_card", allocated_before_gc=before,
        allocated_after_gc=torch.cuda.memory_allocated())
    torch.cuda.empty_cache()


# the device setup's phases (setup/interp.py, setup/device_setup.py) and
# the generic batched path's (ops/batched_eig.py through interp.py)
SETUP_PHASES = ("setup.device_pipeline", "setup.device_pipeline.eigh",
                "setup.device_pipeline.fetch", "setup.device_pipeline.aes",
                "setup.device_pipeline.rr", "setup.ae_assembly",
                "setup.local_eigensolves", "setup.local_eigensolves.host",
                "setup.local_eigensolves.resolve",
                "setup.filtered_eig.first", "setup.filtered_eig.rest")


def timed_setup(path, build, dev, torch):
    """Run ``build()`` (a host or device setup) with the setup timers
    and the card's peak memory counter reset; log its seconds, the
    timers' split, the AEs per eigensolver route of each level and the
    peak device bytes.  Returns (build's result, setup seconds)."""
    from saamge_tpu_torch.utils.logging import TIMERS
    TIMERS.reset()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = build()
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    ml = out[0]
    tot = TIMERS.totals
    eig_s = tot.get("setup.device_pipeline", 0.0) \
        + tot.get("setup.local_eigensolves", 0.0)
    log(path + " setup", setup_s=f"{setup_s:.2f}",
        eigensolve_s=f"{eig_s:.2f}", rest_s=f"{setup_s - eig_s:.2f}",
        split=json.dumps({k: round(tot[k], 3) for k in SETUP_PHASES
                          if k in tot}),
        routes=json.dumps([lv.tg_data.interp_data.eig_routes
                           for lv in ml.levels]),
        peak_device_bytes=peak,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    log(path + " timers", all=json.dumps({k: round(v, 3)
                                          for k, v in sorted(tot.items())}))
    return out, setup_s


def host_pcg_iters(ml, A, b, np, tols=TOLS):
    """Host f64 PCG iterations with the hierarchy's V-cycle (the
    SpectralAMGSolver solve), at each tolerance."""
    from saamge_tpu_torch.solve.pcg import pcg
    from saamge_tpu_torch.solve.vcycle import VCycleSolver
    pre = VCycleSolver(ml.finest.tg_data)
    pre.set_operator(A)

    def mult(r):
        z = np.zeros_like(r)
        pre.mult(r, z)
        return z
    return [pcg(A, b, mult, rel_tol=t, max_iter=300).iterations
            for t in tols]


def nearest_theta(interp, p, theta, np):
    """The eigenvalue of AE p's scaled operator B^-1/2 A B^-1/2 nearest
    theta (host f64, from the level's AE and B)."""
    A = interp.AEs_stiffm[p]
    A = A.toarray() if hasattr(A, "toarray") else np.asarray(A)
    dh = 1.0 / np.sqrt(interp.rhs_matrices_arr[p])
    ev = np.linalg.eigvalsh(dh[:, None] * A * dh[None, :])
    return float(ev[np.argmin(np.abs(ev - theta))])


def setup_faults(ml_h, ml_d, np, proj_tol=5e-3):
    """Host against device setup of one problem, per AE: the cut count
    on every level with as many AEs on both sides, and on the finest
    level (the same AE operators on both sides; a coarser level's AEs
    are written in each setup's own tent basis) the B-projector's
    difference relative to the host's.  Returns (faults, worst
    projector difference); a fault is (level, AE, host count, device
    count, the eigenvalue nearest theta)."""
    faults, worst = [], 0.0
    for lev, (lh, ld) in enumerate(zip(ml_h.levels, ml_d.levels)):
        ih, idv = lh.tg_data.interp_data, ld.tg_data.interp_data
        if len(ih.cut_evects_arr) != len(idv.cut_evects_arr):
            faults.append((lev, None, len(ih.cut_evects_arr),
                           len(idv.cut_evects_arr), None))
            continue
        for p, (Xh, Xd) in enumerate(zip(ih.cut_evects_arr,
                                         idv.cut_evects_arr)):
            if Xh.shape[1] != Xd.shape[1]:
                faults.append((lev, p, Xh.shape[1], Xd.shape[1],
                               nearest_theta(ih, p, lh.tg_data.theta, np)))
            elif lev == 0:
                Ph = Xh @ Xh.T * ih.rhs_matrices_arr[p][None, :]
                Pd = Xd @ Xd.T * idv.rhs_matrices_arr[p][None, :]
                d = float(np.linalg.norm(Pd - Ph) / np.linalg.norm(Ph))
                worst = max(worst, d)
                if not d <= proj_tol:
                    faults.append((lev, p, "projector", d, None))
    return faults, worst


def setup_parity(dev, torch, np, flagship_problem, general_problem):
    """Phase 3b: the host and the device setup of a small flagship and a
    small hexkway problem agree per AE, in coarse dims and in host PCG
    iterations (within 1)."""
    cases = (("flagship n=32", lambda ds: flagship_problem(
                 n=32, brick=8, supers=(2, 2, 2), device_setup=ds,
                 device=dev)),
             ("hexkway n=24", lambda ds: general_problem(
                 n=24, device_setup=ds, device=dev)))
    for name, build in cases:
        (ml_h, *rest), _ = timed_setup(f"parity {name} host",
                                       lambda: build(False), dev, torch)
        (ml_d, *_), _ = timed_setup(f"parity {name} device",
                                    lambda: build(True), dev, torch)
        A, b = (ml_h.levels[0].A, rest[0]) if name.startswith("flagship") \
            else (rest[0], rest[1])
        dims = [[int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
                for ml in (ml_h, ml_d)]
        its = [host_pcg_iters(ml, A, b, np) for ml in (ml_h, ml_d)]
        faults, worst = setup_faults(ml_h, ml_d, np)
        log("parity", case=name, coarse_dims_host=dims[0],
            coarse_dims_device=dims[1], host_pcg_iters=its[0],
            device_pcg_iters=its[1], aes=len(ml_h.levels[0].tg_data
                                            .interp_data.cut_evects_arr),
            worst_projector_rel_diff=f"{worst:.3e}", faults=faults)
        if faults or dims[0] != dims[1] or any(
                abs(a - c) > 1 for a, c in zip(*its)):
            raise RuntimeError(f"setup parity {name}: dims {dims}, PCG "
                               f"{its}, per-AE faults {faults}")
        del ml_h, ml_d, rest
    leave_card(torch)


BARRIER_PROBE = r'''
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(256) barriers(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}
extern "C" int grid_barriers(int blocks, int syncs, void* stream) {
  void* args[] = {(void*)&syncs};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barriers, dim3(blocks), dim3(256), args, 0,
      (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
'''


def barrier_probe(torch, build, syncs=1000):
    """A function of a block count: the time of one grid barrier in a
    cooperative grid of that many blocks of 256 threads, from an empty
    cooperative kernel of ``syncs`` barriers against one of none, CUDA
    events.  Built here with nvcc; it is a measuring probe, not a kernel
    of any path."""
    import ctypes
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "grid_barriers.cu")
    so = os.path.join(build.BUILD_DIR, "grid_barriers.so")
    with open(src, "w") as f:
        f.write(BARRIER_PROBE)
    subprocess.run([build._nvcc()] + build.NVCC_FLAGS
                   + ["-shared", "-o", so, src], check=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.grid_barriers.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]

    def us(blocks):
        def run(n):
            code = lib.grid_barriers(blocks, n, build.stream_ptr(
                torch.device("cuda", 0)))
            if code != 0:
                raise RuntimeError(f"grid barrier probe: CUDA error {code}")

        t_n = median_ms(lambda: run(syncs), torch, draws=5, calls=5)
        t_0 = median_ms(lambda: run(0), torch, draws=5, calls=5)
        return (t_n - t_0) * 1e3 / syncs

    return us


def per_level(name, dev_long, levels_long, dev_short, levels_short,
              b_us, blocks):
    """Device time per level of a chained kernel from two launches of
    different depth (the difference removes what a launch pays once),
    beside the time of one grid barrier of its grid."""
    lvl = (dev_long - dev_short) * 1e3 / (levels_long - levels_short)
    log("levels", kernel=name, levels=f"{levels_short}->{levels_long}",
        us_per_level=f"{lvl:.3f}",
        us_once=f"{dev_short * 1e3 - levels_short * lvl:.3f}",
        barrier_us=f"{b_us:.3f}", grid_blocks=blocks)


def synthetic(dev, torch, np, k, device_profile, build):
    """The stencil and the sweep on n=96-shaped operands from a numpy
    seed (27 diagonals with hex_mesh(96)'s offsets, positive dinv, 10
    roots + the residual), the sweep's device time per level beside the
    time of one grid barrier of its grid, and the general smoother on
    n=64-shaped f32 operands; the resident mid chain on n=96-shaped
    brick blocks (12^3 bricks, bs 20, 27 offsets of 13 x 13 used slots:
    15.8 MB of bf16 rectangles) and the matrix-free pass and chain on a
    97^3 node grid, each with its time per level."""
    rng = np.random.default_rng(96)
    DIA = k["DIA"]
    records = []
    barrier = barrier_probe(torch, build)
    with open(os.path.join(build.CSRC, "wavefront.cu")) as f:
        per_sm = int(re.search(r"#define WAVE_MIN_BLOCKS (\d+)",
                               f.read()).group(1))
    blocks = per_sm * torch.cuda.get_device_properties(0) \
        .multi_processor_count
    b_us = barrier(blocks)
    for nn, name, dtype in ((96, "wavefront", torch.bfloat16),
                            (64, "smoother", torch.float32)):
        dims = (nn + 1,) * 3
        n = dims[0] ** 3
        A = random_dia(DIA, torch, np, rng, stencil_offsets(dims), n,
                       torch.float32, dev)
        As = DIA(A.vals.to(dtype), A.offsets, n)
        xh, bh, dh = sweep_vectors(A, torch, np, rng, dev)
        taus = tuple(float(t) for t in rng.uniform(0.3, 0.9, 10))
        hvec, k0 = n + 2 * A.halo, 27
        sweep = k[name]
        cases = [(name, 1e-4, "wavefront.cu",
                  "pallas_wavefront.py:123" if nn == 96
                  else "pallas_smoother.py:36",
                  lambda: sweep(As, taus, bh, dh, xh, True),
                  lambda: k["wavefront_plain"](As, taus, bh, dh, xh, True),
                  (nbytes(As.vals) + 5 * hvec * 4,
                   10 * (2 * k0 + 4) * n + (2 * k0 + 1) * n), None)]
        if nn == 96:
            cases.insert(0, (
                "stencil", 1e-5, "stencil.cu", "pallas_stencil.py:61",
                lambda: k["stencil"]("spmv", A, xh),
                lambda: k["stencil_plain"]("spmv", A, xh),
                (nbytes(A.vals) + 2 * hvec * 4, 2 * k0 * n), None))
        records += run_kernels(cases, torch, device_profile)
        records[-1]["case"] = f"synthetic n={nn}, {dtype}, 10 roots + res"
        # 11 levels (10 roots + the residual), 10 barriers
        lvl = records[-1]["device_ms"] * 1e3 / 11
        log("levels", kernel=name, levels=11,
            us_per_level=f"{lvl:.3f}", barrier_us=f"{b_us:.3f}",
            grid_blocks=blocks,
            barrier_share=f"{10 * b_us / (11 * lvl):.4f}")
        del A, As, xh, bh, dh
        leave_card(torch)

    # the resident mid chain
    bricks, bs = (12, 12, 12), 20
    NB = 12 ** 3
    doffs = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1))
    rects = ((13, 13),) * 27
    blocks1 = torch.zeros(27, bs, bs, NB)
    blocks1[:, :13, :13] = torch.as_tensor(
        rng.uniform(-0.05, 0.05, (27, 13, 13, NB)), dtype=torch.float32)
    blocks1 = blocks1.to(torch.bfloat16).to(dev)
    plan = k["mid_tile_plan"](bricks, bs, rects, *k["card_limits"](dev), 2)
    tiles = k["pack_tiles"](blocks1, rects, plan.tile)
    b1, x1 = (torch.as_tensor(rng.standard_normal(bs * NB),
                              dtype=torch.float32).to(dev) for _ in range(2))
    d1 = torch.as_tensor(rng.uniform(0.5, 1.0, bs * NB),
                         dtype=torch.float32).to(dev)
    taus1 = (0.9, 0.6, 1.1, 0.7)
    rect = sum(r1 * r2 * NB for r1, r2 in rects)
    args = (blocks1, tiles, plan, doffs, rects, bricks)
    log("synthetic", mid_tiles=plan.tiles, mid_tile_bricks=plan.tile,
        mid_threads=plan.threads, mid_shared_bytes=plan.smem,
        mid_rect_bytes=rect * 2)
    records += run_kernels([
        ("mid_chain", 1e-4, "midsmooth.cu", "pallas_midsmooth.py:136",
         lambda: k["mid_chain"](*args, taus1, b1, d1, x1, True),
         lambda: k["mid_chain_plain"](blocks1, doffs, bricks, taus1, b1, d1,
                                      x1, True),
         (rect * 2 + 5 * bs * NB * 4, 5 * 2 * rect + 4 * 4 * bs * NB),
         None)], torch, device_profile)
    records[-1]["case"] = "synthetic n=96 shapes, bf16, 4 roots + res"
    one = device_ms(lambda: k["mid_chain"](*args, taus1[:1], b1, d1, x1),
                    torch, device_profile)
    per_level("mid_chain", records[-1]["device_ms"], 5, one, 1,
              barrier(plan.tiles), plan.tiles)
    del blocks1, tiles, args
    leave_card(torch)

    # the matrix-free pass and chain
    dims = (97, 97, 97)
    n = 97 ** 3
    op32 = random_mfree(k["MatrixFreeQ1"], torch, np, rng, dims,
                        torch.float32, dev)
    op16 = k["MatrixFreeQ1"](op32.c_h.to(torch.bfloat16),
                             op32.m_h.to(torch.bfloat16), op32.K, dims)
    xh, bh, dh = sweep_vectors(op32, torch, np, rng, dev)
    hvec = n + 2 * op32.halo
    taus = tuple(float(t) for t in rng.uniform(0.3, 0.9, 10))
    chain = (op16, taus, bh, dh, xh, True)
    records += run_kernels([
        ("mfree", 1e-5, "mfree.cu", "pallas_mfree.py:100",
         lambda: k["mfree"]("spmv", op32, xh),
         lambda: k["mfree_plain"]("spmv", op32, xh),
         (nbytes(op32.c_h, op32.m_h) + 2 * hvec * 4,
          mfree_flops(n, spmv=True)), None),
        ("mfree_chain", 1e-4, "mfree.cu", "pallas_mfree.py:100",
         lambda: k["mfree_chain"](*chain),
         lambda: k["mfree_chain_plain"](*chain),
         (nbytes(op16.c_h, op16.m_h) + 5 * hvec * 4,
          mfree_flops(n, len(taus), residual=True)), None),
    ], torch, device_profile)
    records[-2]["case"] = "synthetic 97^3 nodes, spmv, f32 c/m"
    records[-1]["case"] = "synthetic 97^3 nodes, bf16 c/m, 10 roots + res"
    bit_checks("synthetic", [
        (f"mfree {mode}", lambda op=op, mode=mode, kw=kw:
         k["mfree"](mode, op, xh, **kw),
         lambda op=op, mode=mode, kw=kw: k["mfree_point"](mode, op, xh, **kw))
        for mode, op, kw in (("spmv", op32, {}), ("residual", op16,
                                                  {"bh": bh}),
                             ("root", op16, {"bh": bh, "dinvh": dh,
                                             "inv_tau": 0.7}))]
        + [("mfree_chain", lambda: k["mfree_chain"](*chain),
            lambda: mfree_passes(k["mfree"], *chain))], torch)
    point = device_ms(lambda: k["mfree_point"]("spmv", op32, xh), torch,
                      device_profile)
    log("synthetic", mfree_point_reference_device_ms=f"{point:.4f}")
    one = device_ms(lambda: k["mfree_chain"](op16, taus[:1], bh, dh, xh),
                    torch, device_profile)
    grid = k["mfree_plan"](dims, torch.cuda.get_device_properties(0)
                           .multi_processor_count).blocks
    per_level("mfree_chain", records[-1]["device_ms"], 11, one, 1,
              barrier(grid), grid)
    del op32, op16, xh, bh, dh, chain
    leave_card(torch)
    return records


# the sharded path (phase 9b): shard counts of its slices on one card
SHARDS = (1, 2, 4)
NOT_SHARDED = ("wavefront", "mfree", "mfree_chain", "smoother", "contract_R",
               "contract_P")


def sharded_solves(torch):
    """The sharded solve behind run_slice's interface of flat vectors:
    ``vcycle(hs, b)`` and ``pcg(hs, b, tol)`` scatter b over the shards
    and gather the result."""
    from saamge_tpu_torch.parallel.structured_sharded import (
        gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
        scatter_fine)

    def vcycle(hs, b, graph=True):
        return gather_fine(hs, make_struct_sharded_vcycle(hs, graph)(
            scatter_fine(hs, b)))

    def pcg(hs, b, tol, graph=True):
        x, it = make_struct_sharded_pcg(hs, graph=graph)(
            scatter_fine(hs, b), tol)
        return gather_fine(hs, x), it, None

    return vcycle, pcg


def sharded_kernels(h, kern, torch, np, dev, vec, device_profile):
    """Phase 9b's kernels against their plain versions at the slab
    shapes of the flagship hierarchy ``h`` on 4 shards of ``dev``: the
    stencil on an interior slab (halos filled from both neighbours) in
    its three modes with the f32 and the bf16 diagonals, window R / P on
    the slab's bricks (records), window R / P on slabs of 1, BX/4 and
    BX/2 brick layers, and the stencil on a one-plane slab (two node
    planes), whose halo holds one neighbour plane a side: equal bit for
    bit to the same rows of the single-card pass.  Returns the
    records."""
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.parallel.structured_sharded import (
        scatter_fine, shard_structured)
    DIA, stencil_h, stencil_plain = (kern["DIA"], kern["stencil"],
                                     kern["stencil_plain"])
    window_R, window_P = kern["window_R"], kern["window_P"]
    R_plain, P_plain = kern["window_R_plain"], kern["window_P_plain"]
    geo = h.geo
    hs = shard_structured(h, ShardMesh([dev] * 4))
    st, s = hs.st, hs.shards[1]          # an interior shard
    A0 = DIA(s.A0_vals, st.offsets, st.real)
    A0s = DIA(s.A0s_vals, st.offsets, st.real)
    xh = hs.halo_fill(hs.pad(scatter_fine(hs, vec(h.n))))[1]
    bh = hs.pad(scatter_fine(hs, vec(h.n)))[1]
    r, xc = vec(st.real), vec(st.bs * st.nb_loc)
    _, BY, BZ = geo.bricks
    sgeo = ((st.bxl, BY, BZ), geo.brick_elems)
    hvec = st.real + 2 * st.halo
    k = len(st.offsets)
    # the library yardsticks: the slab's rows of A0 as a CSR product on
    # the haloed x, and the slab's tent as a CSR product
    rows = torch.arange(st.real, device=dev).repeat(k)
    cols = (torch.arange(st.real, device=dev)[None] + st.halo
            + torch.tensor(st.offsets, device=dev)[:, None]).reshape(-1)
    vals = A0.vals.reshape(-1)
    keep = vals != 0
    A_csr = sparse_csr(rows[keep], cols[keep], vals[keep],
                       (st.real, hvec), torch)
    Rc, Pc = tent_csr(s.Rst, *sgeo, torch)
    nnz = Rc.values().numel()
    tent_work = (nnz * s.Rst.element_size() + (st.real + xc.numel()) * 4,
                 2 * nnz)
    records = run_kernels([
        ("stencil_slab", 1e-5, "stencil.cu", "pallas_stencil.py:61",
         lambda: stencil_h("spmv", A0, xh),
         lambda: stencil_plain("spmv", A0, xh),
         (nbytes(A0.vals) + 2 * hvec * 4, 2 * k * st.real),
         lambda: A_csr @ xh[:, None]),
        ("window_R_slab", 1e-5, "window.cu", "pallas_window.py:144",
         lambda: window_R(s.Rst, r, *sgeo),
         lambda: R_plain(s.Rst, r, *sgeo), tent_work,
         lambda: Rc @ r[:, None]),
        ("window_P_slab", 1e-5, "window.cu", "pallas_window.py:193",
         lambda: window_P(s.Rst, xc, *sgeo, ranges=s.Rst_rng),
         lambda: P_plain(s.Rst, xc, *sgeo), tent_work,
         lambda: Pc @ xc[:, None]),
    ], torch, device_profile)
    case = (f"shard 1 of 4 on one card: {st.sp1} node planes "
            f"({st.real} rows), {st.bxl} x {BY} x {BZ} bricks")
    for rec, w in zip(records, ("stencil", "window_R", "window_P")):
        rec.update(wrapper=w, case=case)
    root_kw = {"bh": bh, "dinvh": s.dinv0h, "inv_tau": st.taus0[0]}
    modes = (("spmv", {}), ("residual", {"bh": bh}), ("root", root_kw))
    for name, A in (("stencil_slab_f32", A0), ("stencil_slab_bf16", A0s)):
        check_modes(name, lambda mode, A=A, **kw: stencil_h(mode, A, xh, **kw),
                    lambda mode, A=A, **kw: stencil_plain(mode, A, xh, **kw),
                    modes, torch)
    BX = geo.bricks[0]
    bx = geo.brick_elems[0]
    for bxl in sorted({1, BX // 4, BX // 2}):
        nb = bxl * BY * BZ
        cut = slice(nb, 2 * nb)               # the second slab
        Rst = h.Rst[:, :, cut].contiguous()
        rng = h.Rst_rng[:, :, cut].contiguous()
        g = ((bxl, BY, BZ), geo.brick_elems)
        rr, xcc = vec((bxl * bx + 1) * st.plane), vec(h.bs * nb)
        _, eR = rel_err(window_R(Rst, rr, *g), R_plain(Rst, rr, *g))
        _, eP = rel_err(window_P(Rst, xcc, *g, ranges=rng),
                        P_plain(Rst, xcc, *g))
        log("sharded kernel", window_bricks=g[0], window_R_rel_err=f"{eR:.3e}",
            window_P_rel_err=f"{eP:.3e}", tol=1e-5)
        if not max(eR, eP) <= 1e-5:
            raise RuntimeError(f"window R / P on {g[0]} bricks: rel err "
                               f"{eR:.3e} / {eP:.3e}")
    # a one-plane slab: node planes m and m + 1 of the grid
    p, halo = st.plane, st.halo
    lo = (geo.nodes[0] // 2) * p
    n1 = 2 * p
    A1 = DIA(h.A0.vals[:, lo:lo + n1].contiguous(), st.offsets, n1)
    x = vec(h.n)
    y_glob = stencil_h("spmv", h.A0, h.A0.pad(x))[halo + lo:halo + lo + n1]
    x1 = torch.zeros(n1 + 2 * halo, device=dev)
    x1[halo - p:halo + n1 + p] = x[lo - p:lo + n1 + p]
    y1 = stencil_h("spmv", A1, x1)
    _, e1 = rel_err(y1, stencil_plain("spmv", A1, x1))
    same = torch.equal(y1[halo:halo + n1], y_glob)
    log("sharded kernel", one_plane_slab_rows=n1, halo=halo,
        filled_rows_a_side=p, rel_err_vs_plain=f"{e1:.3e}",
        equal_to_single_card_rows=same)
    if not (e1 <= 1e-5 and same):
        raise RuntimeError(f"one-plane slab stencil: rel err {e1:.3e}, "
                           f"equal to the single-card rows: {same}")
    return records


def sharded_rap_check(ml, geo, dev, torch, Ac_dev, Ac_host, P=4):
    """The sharded Galerkin product of ``ml``'s level 0 over ``P`` shards
    of ``dev`` against the host f64 product (within 1e-5 of max |Ac|,
    equal nnz) and the one-device product (within 1e-6); logs its
    seconds."""
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.setup.device_rap import sharded_structured_rap
    lv0 = ml.levels[0]
    tg0 = lv0.tg_data
    leave_card(torch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    Ac = sharded_structured_rap(lv0.A, lv0.rels, tg0.tent_interp,
                                tg0.interp_data.mis_numcoarsedof, geo,
                                ShardMesh([dev] * P))
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    scale = float(abs(Ac_host).max())
    d_host = float(abs(Ac - Ac_host).max()) / scale
    d_one = float(abs(Ac - Ac_dev).max()) / scale
    log("sharded rap", shards=P, seconds=f"{sec:.3f}", nnz=Ac.nnz,
        host_nnz=Ac_host.nnz, rel_diff_host=f"{d_host:.3e}",
        rel_diff_one_device=f"{d_one:.3e}", peak_device_bytes=peak)
    if not (d_host <= 1e-5 and d_one <= 1e-6 and Ac.nnz == Ac_host.nnz):
        raise RuntimeError(f"sharded RAP: {d_host:.3e} / {d_one:.3e} of "
                           f"max |Ac| off the host / one-device product, nnz "
                           f"{Ac.nnz} vs {Ac_host.nnz}")
    leave_card(torch)


def multi_card(h, cards, bd, vcycle, pcg, torch):
    """The 4-shard solve, distributed and replicated mid, with shard d on
    card d % ``cards`` against the same on one card: V-cycle, PCG
    iterations and x bit for bit, eager loops; logs the eager ms an
    iteration of both."""
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.parallel.structured_sharded import shard_structured
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--cards {cards}: {torch.cuda.device_count()} "
                           "cards here")
    one = ShardMesh([bd.device] * 4)
    spread = ShardMesh([torch.device("cuda", d % cards) for d in range(4)])
    for rep in (None, True):
        out = {}
        for name, mesh in (("one_card", one), ("cards", spread)):
            hs = shard_structured(h, mesh, mid_replicated=rep)
            y = vcycle(hs, bd, graph=False)
            for d in range(cards):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            x, it, _ = pcg(hs, bd, 1e-8, graph=False)
            for d in range(cards):
                torch.cuda.synchronize(d)
            out[name] = (y, x, it,
                         (time.perf_counter() - t0) * 1e3 / max(it, 1))
            del hs
        same = [torch.equal(a, b) for a, b in zip(out["cards"][:2],
                                                  out["one_card"][:2])]
        log("sharded4 cards", cards=cards, mid_replicated=bool(rep),
            devices=[str(d) for d in spread.devices],
            vcycle_bit_equal=same[0], x_bit_equal=same[1],
            pcg_iters_1e8=(out["cards"][2], out["one_card"][2]),
            eager_ms_per_iter=(f"{out['cards'][3]:.4f}",
                               f"{out['one_card'][3]:.4f}"))
        if not (all(same) and out["cards"][2] == out["one_card"][2]):
            raise RuntimeError(f"4 shards on {cards} cards differ from 4 "
                               f"shards on one card (mid_replicated={rep})")


def sharded_path(h, h_cpu, hp, b_np, A_host, torch, np,
                 device_profile, flag_its, device_setup):
    """Phase 9b: the flagship hierarchy ``h`` (on the card) sharded over
    1, 2 and 4 shards of its card, each through the slice (run_slice:
    the V-cycle against the CPU-sharded copy and eager against graph,
    PCG by both loops with the graph loop's kernel records; no CPU PCG),
    its V-cycle within 1e-3 of the single-card flagship's, equal PCG
    iterations at every shard count and within 1 of ``flag_its`` (the
    flagship's, when it ran); then the replicated mid at 4 shards on the
    resident route (``h``) and the packed route (``hp``): their launches
    and graph / eager iterations and x; then the production-regime check
    at ns=48, bricks of 6, on 2 and 4 shards.  Returns the 4-shard
    slice's result."""
    from saamge_tpu_torch.parallel.checks import \
        production_regime_sharded_check
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.parallel.structured_sharded import (
        mid_bytes_per_device, shard_structured)
    from saamge_tpu_torch.solve.structured import struct_vcycle_apply
    from saamge_tpu_torch.utils.logging import TIMERS
    dev = next(h.buffers()).device
    vcycle, pcg = sharded_solves(torch)
    bd = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    y_flag = struct_vcycle_apply(h, bd).cpu()
    its, out = {}, None
    for P in SHARDS:
        path = f"sharded{P}"
        hs = shard_structured(h, ShardMesh([dev] * P))
        hs_cpu = shard_structured(h_cpu, ShardMesh(["cpu"] * P))
        # the distributed mid rounds x to the bf16 blocks' dtype at every
        # mid product (as JAX's), so an f32 sum order that differs
        # between card and CPU moves a rounded entry by up to one bf16
        # step: the V-cycle holds to the CPU copy's within 2^-8, as the
        # dense mid's does (phase 9)
        res = run_slice(path, hs, hs_cpu, b_np, A_host, torch, np, vcycle,
                        pcg, device_profile, cpu_pcg=False,
                        cpu_tol=2.0 ** -8)
        check_launches(path, res["launches"],
                       ("stencil", "window_R", "window_P"),
                       NOT_SHARDED + ("mid_chain", "midmv"))
        _, v_rel = rel_err(res["vcycle"], y_flag)
        its[P] = res["it"]
        log(path, shards=P, pcg_iters=res["it"],
            vcycle_vs_flagship_rel_diff=f"{v_rel:.3e}",
            mid_bytes=json.dumps(mid_bytes_per_device(hs)))
        if not v_rel <= 1e-3:
            raise RuntimeError(f"{path}: V-cycle {v_rel:.3e} off the "
                               "single-card flagship's")
        out = res
        del hs, hs_cpu
        leave_card(torch)
    if len(set(its.values())) != 1:
        raise RuntimeError(f"sharded PCG iterations differ by shard count: "
                           f"{its}")
    if flag_its is not None and any(
            abs(a - c) > 1 for a, c in zip(flag_its, out["it"])):
        raise RuntimeError(f"sharded PCG {out['it']} vs flagship {flag_its}")
    for route, hh, mid_kernel in (("resident", h, "mid_chain"),
                                  ("packed", hp, "midmv")):
        path = f"sharded4 replicated {route}"
        hs = shard_structured(hh, ShardMesh([dev] * 4), mid_replicated=True)
        before = dict(TIMERS.counters)
        _, it6, _ = pcg(hs, bd, 1e-6, graph=False)
        launches = launch_counts(before)[0]
        xe, it8e, _ = pcg(hs, bd, 1e-8, graph=False)
        xg, it8g, _ = pcg(hs, bd, 1e-8)
        _, v_rel = rel_err(vcycle(hs, bd).cpu(), y_flag)
        log(path, mid_route=hh.mid_route, launches=launches,
            pcg_iters=(it6, it8g), eager_iters_1e8=it8e,
            x_graph_equals_eager=torch.equal(xg, xe),
            vcycle_vs_flagship_rel_diff=f"{v_rel:.3e}",
            mid_bytes=json.dumps(mid_bytes_per_device(hs)))
        check_launches(path, launches,
                       ("stencil", "window_R", "window_P", mid_kernel),
                       NOT_SHARDED)
        if hh.mid_route != route or it8g != it8e or not torch.equal(xg, xe):
            raise RuntimeError(f"{path}: route {hh.mid_route}, graph {it8g} "
                               f"vs eager {it8e} iterations or x differs")
        if not v_rel <= 1e-3 or any(abs(a - c) > 1 for a, c in
                                    zip(out["it"], (it6, it8g))):
            raise RuntimeError(f"{path}: V-cycle {v_rel:.3e} off the "
                               f"flagship's, PCG {(it6, it8g)} vs "
                               f"{out['it']}")
        del hs
        leave_card(torch)
    for P in (2, 4):
        t0 = time.perf_counter()
        chk = production_regime_sharded_check(
            ShardMesh([dev] * P), ns=48, brick=6, device_setup=device_setup)
        log("sharded production", seconds=f"{time.perf_counter() - t0:.1f}",
            **{k: (json.dumps(v) if isinstance(v, dict) else v)
               for k, v in chk.items()})
        leave_card(torch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96,
                    help="flagship mesh size (development only; default 96)")
    ap.add_argument("--brick", type=int, default=8)
    ap.add_argument("--general-n", type=int, default=64,
                    help="general-path mesh size (development only; "
                         "default 64)")
    ap.add_argument("--elasticity-n", type=int, default=40,
                    help="elasticity mesh size (default 40, the cell's)")
    ap.add_argument("--scale-n", type=int, default=128,
                    help="scale-path mesh size (default 128; the driver's "
                         "own default is 200)")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="development only: a comma list of "
                         f"{', '.join(PATHS)} (default all)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="development only: stop each path after its "
                         "kernel phase (no V-cycle, no PCG)")
    ap.add_argument("--synthetic", action="store_true",
                    help="development only: no host setup; time the "
                         "stencil and the sweep on seeded n=96-shaped "
                         "operands")
    ap.add_argument("--cards", type=int, default=1,
                    help="on a machine of several cards: only the "
                         "flagship setup and the 4-shard solve with shard "
                         "d on card d %% CARDS against 4 shards of one "
                         "card, bit for bit (multi_card)")
    ap.add_argument("--host-setup", action="store_true",
                    help="development only: build both paths' "
                         "hierarchies with the host setup "
                         "(device_setup=False), for the host-against-"
                         "device setup time")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"--paths must be among {PATHS}")
    full = not (args.kernels_only or args.synthetic)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_profile import device_profile
    from saamge_tpu_torch import (compile_hierarchy, compile_structured,
                                  elasticity_problem, flagship_problem,
                                  general_problem,
                                  pcg_solve, struct_pcg_solve,
                                  struct_vcycle_apply, vcycle_apply)
    from saamge_tpu_torch.ops import _build
    from saamge_tpu_torch.ops.blockrow import (MODES as BLOCKROW_MODES,
                                               BlockRow, blockrow,
                                               blockrow_plain)
    from saamge_tpu_torch.ops.contract import (contract_P, contract_P_plain,
                                               contract_R, contract_R_plain,
                                               contract_R_plan,
                                               extract_boxes, slot_lists)
    from saamge_tpu_torch.ops.filtered_eig import measure_eig_throughput
    from saamge_tpu_torch.ops.mfree import (MatrixFreeQ1, mfree_chain,
                                            mfree_chain_plain, mfree_h,
                                            mfree_plain_h, mfree_plan,
                                            mfree_point_h)
    from saamge_tpu_torch.ops.midmv import (midmv, midmv_plain,
                                            pack_mid_blocks)
    from saamge_tpu_torch.ops.midsmooth import (card_limits, mid_chain,
                                                mid_chain_plain,
                                                mid_tile_plan, pack_tiles,
                                                tile_plan)
    from saamge_tpu_torch.ops.smoother import smoother_h, smoother_plain
    from saamge_tpu_torch.ops.sparse import DIA, NodeBlock
    from saamge_tpu_torch.ops.vstencil import vstencil, vstencil_plain
    from saamge_tpu_torch.ops.stencil import stencil_h, stencil_plain_h
    from saamge_tpu_torch.ops.symv import symv, symv_plain, tile_rows
    from saamge_tpu_torch.ops.wavefront import (wavefront_plain,
                                                wavefront_smooth)
    from saamge_tpu_torch.ops.window import (box_index, slot_ranges,
                                             window_P, window_P_plain,
                                             window_R, window_R_plain)
    from saamge_tpu_torch.solve.device_pcg import solve_graphs
    from saamge_tpu_torch.utils.logging import TIMERS
    structured_only = ("wavefront", "window_R", "window_P", "mid_chain",
                       "mfree", "mfree_chain", "midmv", "contract_R",
                       "contract_P")
    kern = dict(stencil=stencil_h, wavefront=wavefront_smooth,
                window_R=window_R, window_P=window_P, mid_chain=mid_chain,
                mfree=mfree_h, mfree_chain=mfree_chain, midmv=midmv,
                smoother=smoother_h, contract_R=contract_R,
                contract_P=contract_P, blockrow=blockrow,
                midmv_plain=midmv_plain, pack_mid_blocks=pack_mid_blocks,
                blockrow_plain=blockrow_plain, BlockRow=BlockRow,
                contract_R_plain=contract_R_plain,
                contract_P_plain=contract_P_plain, slot_lists=slot_lists,
                window_R_plain=window_R_plain,
                window_P_plain=window_P_plain, slot_ranges=slot_ranges,
                wavefront_plain=wavefront_plain, DIA=DIA,
                stencil_plain=stencil_plain_h, pack_tiles=pack_tiles,
                mid_chain_plain=mid_chain_plain, mfree_plain=mfree_plain_h,
                mfree_point=mfree_point_h,
                mfree_chain_plain=mfree_chain_plain,
                MatrixFreeQ1=MatrixFreeQ1, card_limits=card_limits,
                mid_tile_plan=mid_tile_plan, tile_plan=tile_plan,
                mfree_plan=mfree_plan, vstencil=vstencil,
                vstencil_plain=vstencil_plain, NodeBlock=NodeBlock,
                symv=symv, symv_plain=symv_plain, symv_tile_rows=tile_rows)

    def s_pcg(h, b, tol, graph=True):
        return struct_pcg_solve(h, b, rel_tol=tol, graph=graph)

    def g_pcg(h, b, tol, graph=True):
        return pcg_solve(h, b, rel_tol=tol, max_iter=300, graph=graph)

    # 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, smi=smi)

    # 2. build ----------------------------------------------------------
    _build.load()
    log("build", seconds=f"{TIMERS.total('kernels.load'):.2f}",
        builds=TIMERS.counters.get("kernels.builds", 0),
        sources=",".join(os.path.relpath(p) for p in _build.sources()),
        flags=" ".join(_build.NVCC_FLAGS))
    # (entry, registers, static shared bytes, spill stores, spill loads)
    ptxas = {k: _build.ptxas_resources(src, k) for src, k in
             (("midmv.cu", "midmv_kernel"), ("window.cu", "window_R_kernel"),
              ("window.cu", "window_P_kernel"),
              ("wavefront.cu", "wavefront_kernel"),
              ("midsmooth.cu", "mid_chain_kernel"),
              ("mfree.cu", "mfree_pass_kernel"),
              ("mfree.cu", "mfree_chain_kernel"),
              ("contract.cu", "contract_R_kernel"),
              ("contract.cu", "contract_P_kernel"),
              ("blockrow.cu", "blockrow_kernel"),
              ("vstencil.cu", "vstencil_chain_kernel"),
              ("symv.cu", "symv_tile_kernel"))}
    log("build", ptxas=json.dumps(ptxas) if all(ptxas.values())
        else "not reported (library loaded from an earlier build)")
    if args.cards > 1:
        ml, b_np, geo, supers = flagship_problem(
            n=args.n, brick=args.brick,
            supers=(2, 2, 2) if args.n < 32 else None,
            device_setup=not args.host_setup, device=dev)
        h = compile_structured(ml, geo, supers, device=dev)
        del ml
        vcycle, pcg = sharded_solves(torch)
        multi_card(h, args.cards, torch.as_tensor(
            b_np, dtype=torch.float32, device=dev), vcycle, pcg, torch)
        return finish([], {}, smi, torch)
    ragged_checks(dev, torch, np, kern)

    if args.synthetic:
        records = synthetic(dev, torch, np, kern, device_profile, _build)
        return finish(records, {}, smi, torch)

    rng = np.random.default_rng(0)

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m),
                               dtype=torch.float32).to(dev)

    def card_csr(rows, cols, vals, shape):
        return sparse_csr(torch.as_tensor(rows).to(dev),
                          torch.as_tensor(cols).to(dev),
                          torch.as_tensor(vals, dtype=torch.float32).to(dev),
                          shape, torch)

    records, results = [], {}
    k0 = 27

    device_setup = not args.host_setup

    # 3. setup ----------------------------------------------------------
    if set(STRUCTURED) & set(paths):
        supers = (2, 2, 2) if args.n < 32 else None
        (ml, b_np, geo, supers, fac), setup_s = timed_setup(
            "flagship", lambda: flagship_problem(
                n=args.n, brick=args.brick, supers=supers, mfree=True,
                device_setup=device_setup, device=dev), dev, torch)
        dims = [int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
        A_host = ml.levels[0].A
        Ac_dev, Ac_host = rap_check("flagship", ml, geo, dev, torch)
        if "sharded" in paths:
            sharded_rap_check(ml, geo, dev, torch, Ac_dev, Ac_host)
        del Ac_dev, Ac_host
        assembly_check(args.n, dev, torch, np)
        t0 = time.perf_counter()
        # the flagship's CPU copy always: its layout, kernel inputs and
        # library yardsticks serve every structured path
        h_cpu = compile_structured(ml, geo, supers, device="cpu")
        packed0 = TIMERS.counters.get("midmv.packed_bytes", 0)
        hc_cpu = compile_structured(
            ml, geo, supers, mfree=fac, hbm_frugal=True,
            ainv_dtype=torch.bfloat16, device="cpu") \
            if "capacity" in paths else None
        packed_counted = TIMERS.counters.get("midmv.packed_bytes", 0) - packed0
        hk_cpu = compile_structured(
            ml, geo, supers, rp_dtype=torch.float32,
            use_pallas_contract=True, device="cpu") \
            if "contract" in paths else None
        # the JAX compile_structured's other branches on the same setup:
        # the dense coarsest restriction, the dense mid operator, the
        # packed mid passes by request
        opt_cpu = {name: compile_structured(ml, geo, sb, device="cpu", **kw)
                   for name, (sb, kw) in (
                       ("dense_R1", (None, {})),
                       ("dense_mid", (supers, {"mid_format": "dense"})),
                       ("packed_mid", (supers, {"mid_resident": False})))
                   } if "options" in paths else {}
        # the replicated mid of the sharded path on the packed route
        hp_cpu = (opt_cpu.get("packed_mid") or compile_structured(
            ml, geo, supers, mid_resident=False, device="cpu")) \
            if "sharded" in paths else None
        compile_s = time.perf_counter() - t0
        if "twolevel" in paths:
            h2_cpu, ainv_f64 = twolevel_compile(ml, geo, dev, torch, np,
                                                compile_structured)
        # the mid operator in the slot-major padded layout: the library
        # yardstick of the packed matvec is one sparse product with it
        Ac = ml.levels[0].tg_data.Ac.tocoo()
        fid = h_cpu.flat_id.numpy()
        mid_coo = (fid[Ac.row], fid[Ac.col], Ac.data)
        ndof = h_cpu.n
        del ml, Ac
        log("setup", n=args.n, ndof=ndof, coarse_dims=dims, bs=h_cpu.bs,
            supers=supers, device_setup=device_setup,
            setup_s=f"{setup_s:.1f}", compile_s=f"{compile_s:.1f}",
            roots=(len(h_cpu.taus0), len(h_cpu.taus1)))
        if args.n == 96 and dims != FLAGSHIP_DIMS:
            raise RuntimeError(f"coarse dims {dims} != {FLAGSHIP_DIMS}")
        geo_args = (geo.bricks, geo.brick_elems)
        box, NB = geo.box, geo.num_bricks
        hvec = ndof + 2 * h_cpu.A0.halo          # haloed vector length
        if device_setup:
            # the filter round at the flagship's chunk shape (512 AEs of
            # (brick+1)^3 = 729 dofs, 64 vectors) beside torch.bmm at the
            # same shapes
            eig = measure_eig_throughput(512, (args.brick + 1) ** 3, 64,
                                         device=dev)
            log("eig_throughput", **{k: (f"{v:.4f}" if isinstance(v, float)
                                         else v) for k, v in eig.items()})
            leave_card(torch)

    # 3b. setup parity ---------------------------------------------------
    if device_setup:
        setup_parity(dev, torch, np, flagship_problem, general_problem)

    # 4. flagship -------------------------------------------------------
    if "flagship" in paths:
        leave_card(torch)
        A_coo = A_host.tocoo()
        A0_csr = card_csr(A_coo.row, A_coo.col, A_coo.data, (ndof, ndof))
        del A_coo
        h = copy.deepcopy(h_cpu).to(dev)
        A0, A0s = h.A0, h.A0s
        xh, bh = A0.pad(vec(ndof)), A0.pad(vec(ndof))
        r_f, xc = vec(ndof), vec(h.n_flat)
        b1, x1 = vec(h.n_flat), vec(h.n_flat)
        # the mid chain's route: the operator resident in shared memory
        mplan = h.mid_plan
        log("flagship", mid_route=h.mid_route,
            mid_tiles=mplan and mplan.tiles,
            mid_tile_bricks=mplan and mplan.tile,
            mid_threads=mplan and mplan.threads,
            mid_shared_bytes=mplan and mplan.smem,
            sms=card_limits(dev)[0])
        if h.mid_route != "resident":
            raise RuntimeError(f"flagship mid route {h.mid_route}: not the "
                               "resident chain")
        mid_args = (h.A1_blocks, h.A1_tiles, mplan, h.doffs, h.rects,
                    geo.bricks, h.taus1)
        A1_csr = card_csr(*mid_coo, (h.n_flat,) * 2)
        root_kw = {"bh": bh, "dinvh": h.dinv0h, "inv_tau": h.taus0[0]}
        Rc, Pc = tent_csr(h.Rst, *geo_args, torch)
        tent_nnz = Rc.values().numel()
        log("library", tent_csr_nnz=tent_nnz, rst_values=h.Rst.numel(),
            A1_csr_nnz=len(mid_coo[2]),
            A1_packed_values=(hc_cpu.A1_packed.numel()
                              if hc_cpu is not None else None),
            slot_range_bytes=nbytes(h.Rst_rng),
            slots_in_ranges=int((h.Rst_rng[1].long()
                                 - h.Rst_rng[0].long()).sum()))
        rect = sum(r1 * r2 * NB for r1, r2 in h.rects)
        r0, r1n = len(h.taus0), len(h.taus1)
        # the tent's structurally nonzero values and the two vectors: what
        # any implementation of R or P must read (the CSR product's work)
        tent_work = (tent_nnz * h.Rst.element_size() + ndof * 4
                     + h.n_flat * 4, 2 * tent_nnz)
        records += run_kernels([
            ("stencil", 1e-5, "stencil.cu", "pallas_stencil.py:61",
             lambda: stencil_h("spmv", A0, xh),
             lambda: stencil_plain_h("spmv", A0, xh),
             (nbytes(A0.vals) + 2 * hvec * 4, 2 * k0 * ndof),
             lambda: A0_csr @ r_f[:, None]),
            ("wavefront", 1e-4, "wavefront.cu", "pallas_wavefront.py:123",
             lambda: wavefront_smooth(A0s, h.taus0, bh, h.dinv0h, xh, True),
             lambda: wavefront_plain(A0s, h.taus0, bh, h.dinv0h, xh, True),
             (nbytes(A0s.vals) + 5 * hvec * 4,
              r0 * (2 * k0 + 4) * ndof + (2 * k0 + 1) * ndof), None),
            ("window_R", 1e-5, "window.cu", "pallas_window.py:144",
             lambda: window_R(h.Rst, r_f, *geo_args),
             lambda: window_R_plain(h.Rst, r_f, *geo_args), tent_work,
             lambda: Rc @ r_f[:, None]),
            ("window_P", 1e-5, "window.cu", "pallas_window.py:193",
             lambda: window_P(h.Rst, xc, *geo_args, ranges=h.Rst_rng),
             lambda: window_P_plain(h.Rst, xc, *geo_args), tent_work,
             lambda: Pc @ xc[:, None]),
            ("mid_chain", 1e-4, "midsmooth.cu", "pallas_midsmooth.py:136",
             lambda: mid_chain(*mid_args, b1, h.dinv1, x1, True),
             lambda: mid_chain_plain(h.A1_blocks, h.doffs, geo.bricks,
                                     h.taus1, b1, h.dinv1, x1, True),
             (rect * h.A1_blocks.element_size() + 5 * h.n_flat * 4,
              (r1n + 1) * 2 * rect + r1n * 4 * h.n_flat), None),
        ], torch, device_profile)
        # a labelled reference, not a library call of the same function:
        # the five passes of the chain as CSR products of A1
        records[-1]["reference"] = {
            "what": "5 x CSR product of A1 (f32 values)",
            "ms": median_ms(lambda: [A1_csr @ x1[:, None] for _ in range(5)],
                            torch, draws=5, calls=4),
            "device_ms": device_ms(lambda: [A1_csr @ x1[:, None]
                                            for _ in range(5)],
                                   torch, device_profile)}
        log("kernel", name="mid_chain", reference=records[-1]["reference"])
        # the stencil kernel's residual and root modes on the bf16 twin
        # (the sweep kernel does their work on the main path)
        check_modes("stencil_bf16",
                    lambda mode, **kw: stencil_h(mode, A0s, xh, **kw),
                    lambda mode, **kw: stencil_plain_h(mode, A0s, xh, **kw),
                    (("residual", {"bh": bh}), ("root", root_kw)), torch)
        mid_full = nbytes(h.A1_blocks)
        del A0, A0s, xh, bh, r_f, xc, b1, x1, mid_args, root_kw, Rc, Pc
        del A0_csr, A1_csr
        if full:
            flag = run_slice("flagship", h, h_cpu, b_np, A_host, torch, np,
                             struct_vcycle_apply, s_pcg, device_profile)
            check_launches("flagship", flag["launches"],
                           ("stencil", "wavefront", "window_R", "window_P",
                            "mid_chain"),
                           ("mfree", "mfree_chain", "midmv", "smoother",
                            "contract_R", "contract_P"))
            it6, it8 = flag["it"]
            if args.n == 96 and (it6 > PCG_MAX[1e-6] or it8 > PCG_MAX[1e-8]):
                raise RuntimeError(f"PCG iterations {it6}/{it8} above "
                                   f"{PCG_MAX[1e-6]}/{PCG_MAX[1e-8]}")
            results["flagship"] = flag
        del h
        leave_card(torch)
    flag = results.get("flagship")

    # 5. capacity -------------------------------------------------------
    if "capacity" in paths:
        A1_csr = card_csr(*mid_coo, (hc_cpu.n_flat,) * 2)
        A_coo = A_host.tocoo()
        A0_csr = card_csr(A_coo.row, A_coo.col, A_coo.data, (ndof, ndof))
        del A_coo
        hc = copy.deepcopy(hc_cpu).to(dev)
        C0, C0s = hc.A0, hc.A0s
        xf = vec(ndof)
        xh, bh = C0.pad(xf), C0.pad(vec(ndof))
        x1 = vec(hc.n_flat)
        root_kw = {"bh": bh, "dinvh": hc.dinv0h, "inv_tau": hc.taus0[0]}
        mv_args = (hc.A1_packed, hc.A1_index, hc.doffs, geo.bricks, hc.bs,
                   x1)
        # the compact mid packing: the level's nonzeros, values and index
        # counted once in midmv.packed_bytes; the pass's bound below counts
        # the values and the vectors only, as roofline_mfree.mid_pass_work
        mid_packed = nbytes(hc.A1_packed, hc.A1_index)
        log("capacity", mid_packed_values=hc.A1_packed.numel(),
            A1_nnz=len(mid_coo[2]), midmv_packed_bytes=packed_counted,
            mid_packed_bytes=mid_packed, mid_index_bytes=nbytes(hc.A1_index))
        if (hc.A1_packed.numel() != len(mid_coo[2])
                or packed_counted != mid_packed):
            raise RuntimeError(
                f"compact mid packing: {hc.A1_packed.numel()} values for "
                f"{len(mid_coo[2])} nonzeros, {packed_counted} bytes "
                f"counted for {mid_packed}")
        chain_args = (C0s, hc.taus0, bh, hc.dinv0h, xh, True)
        records += run_kernels([
            ("mfree", 1e-5, "mfree.cu", "pallas_mfree.py:100",
             lambda: mfree_h("spmv", C0, xh),
             lambda: mfree_plain_h("spmv", C0, xh),
             (nbytes(C0.c_h, C0.m_h) + 2 * hvec * 4,
              mfree_flops(ndof, spmv=True)),
             lambda: A0_csr @ xf[:, None]),
            ("mfree_chain", 1e-4, "mfree.cu", "pallas_mfree.py:100",
             lambda: mfree_chain(*chain_args),
             lambda: mfree_chain_plain(*chain_args),
             (nbytes(C0s.c_h, C0s.m_h) + 5 * hvec * 4,
              mfree_flops(ndof, len(hc.taus0), residual=True)), None),
            ("midmv", 1e-5, "midmv.cu", "pallas_midmv.py:142",
             lambda: midmv(*mv_args), lambda: midmv_plain(*mv_args),
             (nbytes(hc.A1_packed) + 2 * hc.n_flat * 4,
              2 * hc.A1_packed.numel()),
             lambda: A1_csr @ x1[:, None]),
        ], torch, device_profile)
        records[-3]["case"] = "spmv, f32 c/m (the PCG operator)"
        # the first design, one thread a node, kept as the bit reference:
        # the same spmv pass on the same operator and x, timed as the kernel
        records[-3]["reference"] = {
            "what": "mfree_point_h: the one-thread-a-node kernel, the same "
                    "spmv pass on the same inputs",
            "ms": median_ms(lambda: mfree_point_h("spmv", C0, xh), torch,
                            draws=5, calls=20),
            "device_ms": device_ms(lambda: mfree_point_h("spmv", C0, xh),
                                   torch, device_profile)}
        log("kernel", name="mfree", reference=records[-3]["reference"])
        records[-2]["case"] = (f"{len(hc.taus0)} roots + residual, bf16 "
                               "c/m (the smoother twin)")
        records[-1]["case"] = f"spmv, {hc.A1_packed.dtype} compact packing"
        routes0 = mfree_routes()
        bit_checks("capacity", [
            (f"mfree {mode}", lambda op=op, mode=mode, kw=kw:
             mfree_h(mode, op, xh, **kw),
             lambda op=op, mode=mode, kw=kw:
             mfree_point_h(mode, op, xh, **kw))
            for mode, op, kw in (("spmv", C0, {}),
                                 ("residual", C0s, {"bh": bh}),
                                 ("root", C0s, root_kw))]
            + [("mfree_chain", lambda: mfree_chain(*chain_args),
                lambda: mfree_passes(mfree_h, *chain_args))], torch)
        # n=96's working set fits the L2: the flat route
        expect_routes("capacity", routes0,
                      ("flat",) if args.n == 96 else None)
        capacity_bit_checks(kern, torch, np, dev)
        b1 = vec(hc.n_flat)
        mode_kw = {"b": b1, "dinv": hc.dinv1, "inv_tau": hc.taus1[0]}
        check_modes("midmv", lambda mode, **kw: midmv(*mv_args, mode, **kw),
                    lambda mode, **kw: midmv_plain(*mv_args, mode, **kw),
                    (("residual", {"b": b1}), ("root", mode_kw)), torch)
        # residual and root on the bf16 smoother twin
        check_modes("mfree",
                    lambda mode, **kw: mfree_h(mode, C0s, xh, **kw),
                    lambda mode, **kw: mfree_plain_h(mode, C0s, xh, **kw),
                    (("residual", {"bh": bh}), ("root", root_kw)), torch)
        del C0, C0s, xh, xf, bh, x1, b1, root_kw, mode_kw, mv_args, A1_csr
        del A0_csr, chain_args
        if full:
            cap = run_slice("capacity", hc, hc_cpu, b_np, A_host, torch, np,
                            struct_vcycle_apply, s_pcg, device_profile)
            check_launches("capacity", cap["launches"],
                           ("mfree", "mfree_chain", "midmv", "window_R",
                            "window_P"),
                           ("stencil", "wavefront", "mid_chain", "smoother",
                            "contract_R", "contract_P"))
            # single passes only for the PCG matvec: each smoothing chain
            # is one mfree_chain launch
            check_launches("capacity mfree", cap["modes"]["mfree"],
                           ("spmv",), ("residual", "root"))
            check_launches("capacity midmv", cap["modes"]["midmv"],
                           ("root", "residual"), ())
            results["capacity"] = cap
            if flag is not None:
                for tol, a, c in zip(TOLS, flag["it"], cap["it"]):
                    if abs(a - c) > 2:
                        raise RuntimeError(f"capacity PCG {c} vs flagship "
                                           f"{a} iterations at {tol}")
                diags = 27 * ndof * (4 + 2)
                log("memory", flagship_buffer_bytes=flag["buffer_bytes"],
                    capacity_buffer_bytes=cap["buffer_bytes"],
                    stored_diagonal_bytes=diags,
                    full_mid_block_bytes=mid_full,
                    packed_mid_bytes=mid_packed,
                    flagship_peak_bytes=flag["peak_bytes_pcg"],
                    capacity_peak_bytes=cap["peak_bytes_pcg"])
                if cap["buffer_bytes"] > flag["buffer_bytes"] - diags:
                    raise RuntimeError("the capacity hierarchy is not "
                                       "smaller than the flagship by the "
                                       "stored f32 + bf16 diagonals")
        del hc, hc_cpu
        leave_card(torch)

    # 6. contract -------------------------------------------------------
    if "contract" in paths:
        hk = copy.deepcopy(hk_cpu).to(dev)
        rg, sl = hk.Rst_rng, hk.slot_lists
        boxes = extract_boxes(vec(ndof), *geo_args)
        xck = vec(hk.n_flat).view(hk.bs, NB)
        # the tent's nonzero values and the two vectors: what any R or P
        # must move (as tent_work); beside it the 32-byte sectors of Rst
        # that hold a nonzero
        nz = hk.Rst != 0
        nnz = int(nz.sum())
        pad = (-NB) % 8
        sectors = int(torch.nn.functional.pad(nz, (0, pad))
                      .view(hk.bs, box, -1, 8).any(-1).sum())
        vecs = (box + hk.bs) * NB * 4
        kwork = (nnz * hk.Rst.element_size() + vecs, 2 * nnz)
        log("contract", rst_values=hk.Rst.numel(), rst_nnz=nnz,
            nnz_bytes=kwork[0], bound_ms=f"{bound(kwork)[0]:.4f}",
            sector_bytes=sectors * 32 + vecs,
            sector_bound_ms=f"{bound((sectors * 32 + vecs, 0))[0]:.4f}",
            slot_range_bytes=nbytes(rg), slot_list_bytes=nbytes(*sl[:4]),
            fold_index_bytes=nbytes(hk.fold_idx),
            r_plan=contract_R_plan(hk.bs * NB, sl.nlong, sl.nshort))
        del nz
        records += run_kernels([
            ("contract_R", 1e-5, "contract.cu", "pallas_contract.py:47",
             lambda: contract_R(hk.Rst, boxes, lists=sl),
             lambda: contract_R_plain(hk.Rst, boxes), kwork,
             lambda: torch.einsum("cbn,bn->cn", hk.Rst, boxes)),
            ("contract_P", 1e-5, "contract.cu", "pallas_contract.py:47",
             lambda: contract_P(hk.Rst, xck, ranges=rg),
             lambda: contract_P_plain(hk.Rst, xck), kwork,
             lambda: torch.einsum("cbn,cn->bn", hk.Rst, xck)),
        ], torch, device_profile)
        records[-2]["case"] = "f32 Rst, by-slot node lists"
        records[-1]["case"] = "f32 Rst, slot ranges"
        full_rg = torch.stack([torch.zeros_like(rg[0]),
                               torch.full_like(rg[1], hk.bs)])
        bit_checks("contract", [
            ("contract_R repeat", lambda: contract_R(hk.Rst, boxes, sl),
             lambda: contract_R(hk.Rst, boxes, sl)),
            ("contract_P repeat", lambda: contract_P(hk.Rst, xck, rg),
             lambda: contract_P(hk.Rst, xck, rg)),
            ("contract_P full ranges", lambda: contract_P(hk.Rst, xck, rg),
             lambda: contract_P(hk.Rst, xck, full_rg))], torch)
        del boxes, xck, full_rg, sl
        if full:
            con = run_slice("contract", hk, hk_cpu, b_np, A_host, torch, np,
                            struct_vcycle_apply, s_pcg, device_profile)
            check_launches("contract", con["launches"],
                           ("contract_R", "contract_P", "stencil",
                            "wavefront", "mid_chain"),
                           ("window_R", "window_P", "mfree", "mfree_chain",
                            "midmv", "smoother"))
            results["contract"] = con
            if flag is not None:
                for tol, a, c in zip(TOLS, flag["it"], con["it"]):
                    if abs(a - c) > 1:
                        raise RuntimeError(f"contract PCG {c} vs flagship "
                                           f"{a} iterations at {tol}")
        del hk, hk_cpu
        leave_card(torch)
    # 7. general --------------------------------------------------------
    if "general" in paths:
        (ml, A_gen, b_gen), gsetup_s = timed_setup(
            "general", lambda: general_problem(
                n=args.general_n, device_setup=device_setup, device=dev),
            dev, torch)
        gdims = [int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
        if args.general_n == 64 and gdims != GENERAL_DIMS and device_setup:
            # a fault to show per AE: the host setup's cut counts beside
            # the device setup's, with the eigenvalue nearest theta
            ml_h = general_problem(n=args.general_n)[0]
            faults, _ = setup_faults(ml_h, ml, np)
            raise RuntimeError(f"general coarse dims {gdims} != "
                               f"{GENERAL_DIMS}; per-AE faults (level, "
                               f"AE, host, device, eigenvalue nearest "
                               f"theta): {faults}")
        t0 = time.perf_counter()
        g_cpu = compile_hierarchy(ml, torch.float32, device="cpu")
        gcompile_s = time.perf_counter() - t0
        Ac_g = ml.levels[-1].tg_data.Ac
        del ml

        formats = [(fmt(lv.A), fmt(lv.P), lv.fused) for lv in g_cpu.levels]
        log("general", n=args.general_n, ndof=g_cpu.n, coarse_dims=gdims,
            device_setup=device_setup, setup_s=f"{gsetup_s:.1f}",
            compile_s=f"{gcompile_s:.1f}",
            formats=formats, roots=[len(lv.roots) for lv in g_cpu.levels])
        if args.general_n == 64 and gdims != GENERAL_DIMS:
            raise RuntimeError(f"general coarse dims {gdims} != "
                               f"{GENERAL_DIMS}")
        g = copy.deepcopy(g_cpu).to(dev)
        lv0 = g.levels[0]
        G0 = lv0.A
        if not lv0.fused or len(G0.offsets) != 27 or len(lv0.inv_taus) != 10:
            raise RuntimeError(f"general fine level: fused={lv0.fused}, "
                               f"{len(G0.offsets)} offsets, roots "
                               f"{lv0.inv_taus}")
        ghvec = G0.n + 2 * G0.halo
        gx, gb = G0.pad(vec(G0.n)), G0.pad(vec(G0.n))
        records += run_kernels([
            ("smoother", 1e-4, "wavefront.cu", "pallas_smoother.py:36",
             lambda: smoother_h(G0, lv0.inv_taus, gb, lv0.dinvh, gx),
             lambda: smoother_plain(G0, lv0.inv_taus, gb, lv0.dinvh, gx),
             (nbytes(G0.vals) + 4 * ghvec * 4,
              len(lv0.inv_taus) * (2 * k0 + 4) * G0.n), None),
        ], torch, device_profile)
        records[-1]["case"] = "f32, 27 offsets, 10 roots, general fine level"
        del gx, gb, G0, lv0
        records += blockrow_kernels(g, kern, torch, np, device_profile, vec)
        records += symv_kernels("symv_general", g, Ac_g, kern, torch,
                                device_profile, vec)
        if full:
            gen = run_slice("general", g, g_cpu, b_gen, A_gen, torch, np,
                            vcycle_apply, g_pcg, device_profile, exact=False)
            check_launches("general", gen["launches"],
                           ("smoother", "stencil", "blockrow", "symv"),
                           structured_only + VSTENCIL)
            check_launches("general blockrow", gen["modes"]["blockrow"],
                           tuple(BLOCKROW_MODES), ())
            # every block-row product of the card's V-cycles is one launch
            # of the kernel: no plain route (CPU or bucket products)
            bd = torch.as_tensor(b_gen, dtype=torch.float32, device=dev)
            before = dict(TIMERS.counters)
            _, it_e, _ = g_pcg(g, bd, 1e-6, graph=False)
            routes = {k: TIMERS.counters.get(k, 0) - before.get(k, 0)
                      for k in ("blockrow.kernel", "blockrow.plain")}
            # a block-row level's roots and residual; R and P = R^T
            per_cycle = sum(
                (2 * len(lv.roots) + 1) * isinstance(lv.A, BlockRow)
                + 2 * isinstance(lv.R, BlockRow) for lv in g.levels)
            log("general", blockrow_routes=routes, pcg_iters=it_e,
                blockrow_products_per_vcycle=per_cycle)
            if routes["blockrow.plain"] or routes["blockrow.kernel"] != \
                    per_cycle * (it_e + 1):
                raise RuntimeError(f"general block-row routes {routes}, "
                                   f"{per_cycle} products a V-cycle, "
                                   f"{it_e} iterations")
            coarse_checks("general", g, bd, it_e, vcycle_apply,
                          device_profile, torch, before)
            # the kernels of one body replay of the PCG graph (813 before
            # the block-row kernel)
            runner = solve_graphs(g).items[
                ("pcg", torch.float32, bd.device, False)][1]
            body = replay_kernels(runner.graphs[1], torch)
            log("general", body_replay_kernels=body)
            gen["body_replay_kernels"] = body
            it6, it8 = gen["it"]
            if args.general_n == 64 and (it6 > GENERAL_PCG_MAX[1e-6]
                                         or it8 > GENERAL_PCG_MAX[1e-8]):
                raise RuntimeError(f"general PCG iterations {it6}/{it8} "
                                   f"above {GENERAL_PCG_MAX[1e-6]}/"
                                   f"{GENERAL_PCG_MAX[1e-8]}")
            if args.general_n in GENERAL_JAX:
                jdims, jits = GENERAL_JAX[args.general_n]
                log("general", jax_record_coarse_dims=jdims,
                    jax_record_pcg_iters=jits, coarse_dims=gdims,
                    pcg_iters=[it6, it8])
            results["general"] = gen
        del g, g_cpu
        leave_card(torch)

    # 7b. elasticity ----------------------------------------------------
    if "elasticity" in paths:
        (ml, A_el, _), esetup_s = timed_setup(
            "elasticity", lambda: elasticity_problem(
                n=args.elasticity_n, device_setup=device_setup, device=dev),
            dev, torch)
        edims = [int(lv.tg_data.Ac.shape[0]) for lv in ml.levels]
        before = dict(TIMERS.counters)
        t0 = time.perf_counter()
        e_cpu = compile_hierarchy(ml, torch.float32, device="cpu")
        ecompile_s = time.perf_counter() - t0
        counted = (TIMERS.counters.get("vstencil.bytes", 0)
                   - before.get("vstencil.bytes", 0))
        symv_counted = (TIMERS.counters.get("symv.bytes", 0)
                        - before.get("symv.bytes", 0))
        Ac_e = ml.levels[-1].tg_data.Ac
        del ml
        log("elasticity", n=args.elasticity_n, ndof=e_cpu.n,
            coarse_dims=edims, device_setup=device_setup,
            setup_s=f"{esetup_s:.1f}", compile_s=f"{ecompile_s:.1f}",
            formats=[(fmt(lv.A), fmt(lv.P), lv.blocked)
                     for lv in e_cpu.levels],
            roots=[len(lv.roots) for lv in e_cpu.levels],
            fine_nnz=int(A_el.count_nonzero()))
        e = copy.deepcopy(e_cpu).to(dev)
        lv0 = e.levels[0]
        E0 = lv0.A
        if not (lv0.blocked and isinstance(E0, NodeBlock)
                and len(E0.offsets) == 27 and len(lv0.inv_taus) == 10):
            raise RuntimeError(f"elasticity fine level: {fmt(E0)}, "
                               f"blocked={lv0.blocked}, roots "
                               f"{lv0.inv_taus}")
        log("elasticity", vstencil_bytes=counted,
            node_block_bytes=nbytes(E0.vals), halo_nodes=E0.halo,
            symv_bytes=symv_counted, coarse_inv_bytes=nbytes(e.coarse_inv))
        if counted != nbytes(E0.vals):
            raise RuntimeError(f"vstencil.bytes {counted} != the node-block "
                               f"values' {nbytes(E0.vals)} bytes")
        if symv_counted != nbytes(e.coarse_inv):
            raise RuntimeError(f"symv.bytes {symv_counted} != the coarsest "
                               f"tiles' {nbytes(e.coarse_inv)} bytes")
        vstencil_ragged(dev, torch, np, kern)
        records += elasticity_kernels(e, A_el, kern, torch, device_profile,
                                      vec)
        records += symv_kernels("symv_elasticity", e, Ac_e, kern, torch,
                                device_profile, vec)
        if full:
            b_el = np.random.default_rng(2).standard_normal(e.n)
            el = run_slice("elasticity", e, e_cpu, b_el, A_el, torch, np,
                           vcycle_apply, g_pcg, device_profile, exact=False,
                           cpu_pcg=False)
            check_launches("elasticity", el["launches"],
                           ("vstencil_chain", "vstencil_spmv", "blockrow",
                            "symv"),
                           structured_only + ("smoother", "stencil"))
            bd = torch.as_tensor(b_el, dtype=torch.float32, device=dev)
            before = dict(TIMERS.counters)
            _, it_e, _ = g_pcg(e, bd, 1e-6, graph=False)
            routes = {k: TIMERS.counters.get(k, 0) - before.get(k, 0)
                      for k in ("vstencil.kernel.chain", "vstencil.plain",
                                "smoother.kernel", "blockrow.plain")}
            log("elasticity", routes=routes, pcg_iters=it_e)
            if routes["vstencil.plain"] or routes["smoother.kernel"] \
                    or routes["blockrow.plain"] \
                    or routes["vstencil.kernel.chain"] != 2 * (it_e + 1):
                raise RuntimeError(f"elasticity routes {routes}, {it_e} "
                                   "iterations: two node-block chains a "
                                   "V-cycle and no plain route expected")
            coarse_checks("elasticity", e, bd, it_e, vcycle_apply,
                          device_profile, torch, before)
            results["elasticity"] = el
        del e, e_cpu, E0, lv0
        leave_card(torch)

    # 8. twolevel -------------------------------------------------------
    if "twolevel" in paths and full:
        h2 = copy.deepcopy(h2_cpu).to(dev)
        two = run_slice("twolevel", h2, h2_cpu, b_np, A_host, torch, np,
                        struct_vcycle_apply, s_pcg, device_profile)
        check_launches("twolevel", two["launches"],
                       ("stencil", "wavefront", "window_R", "window_P"),
                       ("mid_chain", "midmv", "mfree", "mfree_chain",
                        "smoother", "contract_R", "contract_P"))
        # the same hierarchy with the f64 inverse rounded to f32 (the JAX
        # small-size route) in place of the card's f32 Cholesky inverse
        del h2
        leave_card(torch)
        h2r = copy.deepcopy(h2_cpu)
        h2r.Ainv = ainv_f64
        h2r = h2r.to(dev)
        bd = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
        _, v_rel = rel_err(two["vcycle"], struct_vcycle_apply(h2r, bd).cpu())
        its_ref = tuple(s_pcg(h2r, bd, tol)[1] for tol in TOLS)
        log("twolevel", f64_inverse_vcycle_rel_diff=f"{v_rel:.3e}",
            pcg_iters=two["it"], f64_inverse_pcg_iters=its_ref)
        if any(abs(a - c) > 1 for a, c in zip(two["it"], its_ref)):
            raise RuntimeError(f"twolevel PCG {two['it']} vs {its_ref} with "
                               "the f64 inverse")
        results["twolevel"] = two
        del h2r, bd
        leave_card(torch)
    if "twolevel" in paths:
        del h2_cpu, ainv_f64

    # 9. options ---------------------------------------------------------
    if "options" in paths and full:
        # (route, kernels it must launch, kernels it must not, iterations
        # allowed off the flagship's)
        never = ("mfree", "mfree_chain", "smoother", "contract_R",
                 "contract_P")
        fine = ("stencil", "wavefront", "window_R", "window_P")
        checks = {"dense_R1": ("resident", fine + ("mid_chain",),
                               never + ("midmv",), 0),
                  "dense_mid": ("dense", fine,
                                never + ("mid_chain", "midmv"), 1),
                  "packed_mid": ("packed", fine + ("midmv",),
                                 never + ("mid_chain",), 1)}
        for name, ho_cpu in opt_cpu.items():
            route, must, nope, slack = checks[name]
            if ho_cpu.mid_route != route:
                raise RuntimeError(f"{name}: mid route {ho_cpu.mid_route}, "
                                   f"expected {route}")
            ho = copy.deepcopy(ho_cpu).to(dev)
            # the dense mid rounds x to bf16 at every mid product, so an
            # f32 sum order that differs between card and CPU moves a
            # rounded entry by up to one bf16 step: its V-cycle holds to
            # the CPU copy's within 2^-8; and the plain CPU products widen
            # the 18,917^2 bf16 operator at every matvec, so the CPU copy
            # checks that one V-cycle, not a PCG
            dense = name == "dense_mid"
            opt = run_slice(name, ho, ho_cpu, b_np, A_host, torch, np,
                            struct_vcycle_apply, s_pcg, device_profile,
                            cpu_pcg=not dense,
                            cpu_tol=2.0 ** -8 if dense else 1e-4)
            check_launches(name, opt["launches"], must, nope)
            if name == "packed_mid":
                check_launches("packed_mid midmv", opt["modes"]["midmv"],
                               ("root", "residual"), ("spmv",))
            if flag is not None:
                _, v_rel = rel_err(opt["vcycle"], flag["vcycle"])
                log(name, flagship_pcg_iters=flag["it"], pcg_iters=opt["it"],
                    vcycle_vs_flagship_rel_diff=f"{v_rel:.3e}")
                if any(abs(a - c) > slack
                       for a, c in zip(flag["it"], opt["it"])):
                    raise RuntimeError(f"{name} PCG {opt['it']} vs flagship "
                                       f"{flag['it']} iterations")
                if name == "dense_R1" and not v_rel <= 1e-4:
                    raise RuntimeError(f"dense_R1 V-cycle vs flagship rel "
                                       f"diff {v_rel:.3e} > 1e-4")
            results[name] = opt
            del ho
            leave_card(torch)
    # 9b. sharded -------------------------------------------------------
    if "sharded" in paths:
        h = copy.deepcopy(h_cpu).to(dev)
        records += sharded_kernels(h, kern, torch, np, dev, vec,
                                   device_profile)
        if full:
            hp = copy.deepcopy(hp_cpu).to(dev)
            results["sharded"] = sharded_path(
                h, h_cpu, hp, b_np, A_host, torch, np,
                device_profile, flag["it"] if flag else None, device_setup)
            del hp
        del h
        leave_card(torch)
    if set(STRUCTURED) & set(paths):
        del h_cpu, A_host, opt_cpu, hp_cpu

    # 10. scale ---------------------------------------------------------
    if "scale" in paths and full:
        results["scale"] = scale_path(args.scale_n, args.brick, dev,
                                      kern, torch, np, struct_vcycle_apply,
                                      s_pcg, device_profile)
        leave_card(torch)

    path_of = {"mfree": "capacity", "mfree_chain": "capacity",
               "midmv": "capacity",
               "contract_R": "contract", "contract_P": "contract",
               "smoother": "general", "stencil_slab": "sharded",
               "symv_general": "general", "symv_elasticity": "elasticity",
               **dict.fromkeys(VSTENCIL, "elasticity"),
               **dict.fromkeys((p[0] for p in BLOCKROW_PRODUCTS), "general"),
               "window_R_slab": "sharded", "window_P_slab": "sharded"}
    return finish(records, {rec["name"]: results.get(
        path_of.get(rec["name"], "flagship")) for rec in records}, smi,
        torch)


def finish(records, result_of, smi, torch) -> int:
    """Each record's launches in its path's 1e-6 PCG (None where the
    path ran no PCG), then the card line, the kernels' JSON line and the
    result line."""
    for rec in records:
        res = result_of.get(rec["name"])
        rec["launches"] = (res["launches"][rec.get("wrapper", rec["name"])]
                           if res else None)
    log("done", seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
