"""Port matrix-free Q1 operator (saamge_tpu_torch/ops/mfree.py) against
the JAX Pallas kernel (pallas_mfree.MatrixFreeQ1, interpret mode, flat
layout) and against the stored DIA of the assembled operator, at n=8 and
n=16 with the same numpy-seeded vectors; the chain against the JAX
package's loop of root and residual passes; and the schedules of the
kernel's two routes (tiled, flat) replayed on the CPU, with the plan's
choice between them.  On the CPU the wrappers run their plain torch
versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.fem import assemble
from saamge_tpu.fem.mesh import hex_mesh
from saamge_tpu.ops.pallas_mfree import MatrixFreeQ1 as JaxMatrixFreeQ1
from saamge_tpu.ops.pallas_stencil import PallasDIA
from saamge_tpu.ops.sparse import DeviceDIA

from saamge_tpu_torch.ops.mfree import (CORNERS, FLAT, NODE_BYTES, RUN,
                                        THREADS, WINDOW, MatrixFreeQ1,
                                        flat_plan, mfree_chain,
                                        mfree_chain_plain, mfree_h,
                                        mfree_plan, q1_halo, tiled_plan)
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.stencil import stencil_plain_h

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
INV_TAU = 0.7


def _problem(n, seed=0, contrast=2.0):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(seed)
    coefs = 10.0 ** rng.uniform(-contrast, contrast, mesh.num_elements)
    A, _, _, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    em0, c = assemble.diffusion_factorized(mesh, coefs)
    rng = np.random.default_rng(seed + 1)
    vecs = {k: rng.standard_normal(A.shape[0]).astype(np.float32)
            for k in ("x", "b", "dinv")}
    return (n + 1,) * 3, A, em0, c, ess_dofs, vecs


@pytest.fixture(scope="module", params=[8, 16], ids=["n8", "n16"])
def prob(request):
    return _problem(request.param)


def _port_pass(mode, op, v):
    x, b, d = (op.pad(torch.as_tensor(v[k])) for k in ("x", "b", "dinv"))
    if mode == "spmv":
        return mfree_h("spmv", op, x)
    if mode == "residual":
        return mfree_h("residual", op, x, bh=b)
    return mfree_h("root", op, x, bh=b, dinvh=d, inv_tau=INV_TAU)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_mfree_matches_pallas(prob, mode, dtype):
    """Same c/m storage dtype on both sides, f32 arithmetic on both: the
    sums differ only in order (f32 roundoff, 1e-5 relative)."""
    dims, A, em0, c, ess, v = prob
    tdt, jdt = DTYPES[dtype]
    like = PallasDIA.from_dia(DeviceDIA.try_from_csr(A, jnp.float32,
                                                     max_diags=64),
                              interpret=True)
    jop = JaxMatrixFreeQ1.build(c, ess, em0, dims, 0, like, cdtype=jdt,
                                interpret=True, A_csr=A)
    jx, jb, jd = (jop.pad(jnp.asarray(v[k])) for k in ("x", "b", "dinv"))
    if mode == "spmv":
        ref = jop.matvec_h(jx)
    elif mode == "residual":
        ref = jop.residual_h(jb, jx)
    else:
        ref = jop.root_h(jnp.asarray([INV_TAU], jnp.float32), jb, jd, jx)
    ref = np.asarray(jop.unpad(ref))
    op = MatrixFreeQ1.build(c, ess, em0, dims, tdt, A_csr=A)
    assert op.c_h.dtype == tdt and op.m_h.dtype == tdt
    got = _port_pass(mode, op, v)
    assert torch.all(got[:op.halo] == 0) and torch.all(got[-op.halo:] == 0)
    got = op.unpad(got).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_mfree_matches_stored_dia_every_row(prob, mode):
    """f32 matrix-free vs the stored f32 DIA of the assembled (BC-
    eliminated) operator, on every row: essential rows, the first and
    last planes and the halo included."""
    dims, A, em0, c, ess, v = prob
    op = MatrixFreeQ1.build(c, ess, em0, dims, torch.float32, A_csr=A)
    dia = DIA.from_csr(A, torch.float32)
    assert op.halo == dia.halo and op.n == dia.n
    got = _port_pass(mode, op, v)
    x, b, d = (dia.pad(torch.as_tensor(v[k])) for k in ("x", "b", "dinv"))
    ref = stencil_plain_h(mode, dia, x, bh=b, dinvh=d, inv_tau=INV_TAU)
    err = (got - ref).abs()
    assert float(err.max()) <= 1e-5 * float(ref.abs().max())
    # row by row, against each row's own scale
    scale = torch.as_tensor(abs(A) @ np.abs(v["x"]), dtype=torch.float32)
    rows = err[op.halo:op.halo + op.n]
    if mode == "spmv":
        assert torch.all(rows <= 1e-5 * scale + 1e-30)
    ess_rows = rows[torch.as_tensor(ess)]
    assert float(ess_rows.max()) <= 1e-5 * float(ref.abs().max())


def test_mfree_spmv_matches_csr(prob):
    dims, A, em0, c, ess, v = prob
    op = MatrixFreeQ1.build(c, ess, em0, dims, torch.float32)
    y = op.unpad(mfree_h("spmv", op, op.pad(torch.as_tensor(v["x"]))))
    y = y.numpy()
    ref = A @ v["x"].astype(np.float64)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_mfree_rejects_nonfactorizing_operator():
    dims, A, em0, c, ess, _ = _problem(6)
    c_bad = np.array(c, copy=True)
    c_bad[3] *= 1.5
    with pytest.raises(ValueError, match="factorization"):
        MatrixFreeQ1.build(c_bad, ess, em0, dims, torch.float32, A_csr=A)


def test_mfree_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card is refused, never run by
    the plain version; an unknown mode is refused."""
    dims, A, em0, c, ess, _ = _problem(4)
    op = MatrixFreeQ1.build(c, ess, em0, dims, torch.float32)
    xh = torch.empty(op.n + 2 * op.halo, device="meta")
    with pytest.raises(ValueError, match="devices"):
        mfree_h("spmv", op, xh)
    with pytest.raises(ValueError):
        mfree_h("bogus", op, op.pad(torch.zeros(op.n)))


TAUS = (0.9, 0.6, 1.1)


def _jax_op(prob, jdt):
    dims, A, em0, c, ess, _ = prob
    like = PallasDIA.from_dia(DeviceDIA.try_from_csr(A, jnp.float32,
                                                     max_diags=64),
                              interpret=True)
    return JaxMatrixFreeQ1.build(c, ess, em0, dims, 0, like, cdtype=jdt,
                                 interpret=True, A_csr=A)


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mfree_chain_matches_jax_loop(prob, dtype, emit_res):
    """The chain (the wrapper on the CPU: mfree_chain_plain) against the
    JAX package's matrix-free chain, root_h per root then residual_h
    (saamge_tpu/solve/structured.py _smooth_h), at 1e-5 relative."""
    dims, A, em0, c, ess, v = prob
    tdt, jdt = DTYPES[dtype]
    jop = _jax_op(prob, jdt)
    jx, jb, jd = (jop.pad(jnp.asarray(v[k])) for k in ("x", "b", "dinv"))
    for it in TAUS:
        jx = jop.root_h(jnp.asarray([it], jnp.float32), jb, jd, jx)
    ref = [jx] + ([jop.residual_h(jb, jx)] if emit_res else [])
    op = MatrixFreeQ1.build(c, ess, em0, dims, tdt, A_csr=A)
    x, b, d = (op.pad(torch.as_tensor(v[k])) for k in ("x", "b", "dinv"))
    got = mfree_chain(op, TAUS, b, d, x, emit_residual=emit_res)
    want = mfree_chain_plain(op, TAUS, b, d, x, emit_residual=emit_res)
    got, want = (g if emit_res else (g,) for g in (got, want))
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        r = np.asarray(jop.unpad(r))
        g = op.unpad(g).numpy()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


# -- the kernel's schedule, replayed ----------------------------------------


def _buf(r, k):
    """The chain kernel's output buffer of level r (1-based; k + 1 = the
    residual), csrc/common.cuh level_buf."""
    if r > k:
        return "res"
    return "out" if (k - r) % 2 == 0 else "tmp"


def _items(plan, NXn):
    """Items (block, tile, i0, i1) of a level in the order a block runs
    them: the tiles x chunks of planes (as many chunks as leave an item a
    block, the planes split evenly), item i on block i % plan.blocks
    (csrc/mfree.cu mfree_share)."""
    chunks = max(1, min(NXn, plan.blocks // plan.tiles))
    for it in range(plan.tiles * chunks):
        k = it // plan.tiles
        yield (it % plan.blocks, it % plan.tiles, k * NXn // chunks,
               (k + 1) * NXn // chunks)


class _Tile:
    """One tile's threads as csrc/mfree.cu tile_thread lays them out: the
    window positions fetched (flat offset in plane 0 and ring index), and
    for each thread whose run of RUN nodes along z holds a grid node the
    first node's flat offset and window index and the run's grid nodes."""

    def __init__(self, op, plan, tile):
        NXn, NYn, NZn = op.dims
        sx, sy = op.strides
        y0, z0 = (tile // plan.kz) * plan.ty, (tile % plan.kz) * plan.tz
        wz = plan.tz + 2
        w = torch.arange(WINDOW * THREADS)
        py, pz = w // wz, w % wz
        y, z = y0 + py - 1, z0 + pz - 1
        ok = (w < (plan.ty + 2) * wz) & (y <= NYn) & (z <= NZn)
        self.goff = (op.halo + y * sy + z)[ok]
        self.sidx = (py * plan.pitch + pz)[ok]
        t = torch.arange(THREADS)
        runs = plan.tz // RUN
        ly, lz = t // runs, RUN * (t % runs)
        y, z = y0 + ly, z0 + lz
        nodes = torch.where((ly < plan.ty) & (y < NYn),
                            (NZn - z).clamp(0, RUN), 0)
        act = nodes > 0
        self.t0 = (op.halo + y * sy + z)[act]
        self.ws = ((ly + 1) * plan.pitch + lz + 1)[act]
        self.nodes = nodes[act]


def _taps(op, dx, hh, corner, xn, acc):
    """The nine taps of x-offset dx of node hh: each value from the
    corners' c (``corner(l)``), terms in increasing (l, l') as
    mfree_plain_h adds them, acc += value * x*m in offset order.  Returns
    acc and the group's values."""
    vals = {}
    for l, (ax, ay, az) in enumerate(CORNERS):
        for lp, (bx, by, bz) in enumerate(CORNERS):
            key = (bx - ax, by - ay, bz - az)
            if key[0] == dx:
                term = op.K[l][lp] * corner(l)
                vals[key] = term if key not in vals else vals[key] + term
    for (_, dy, dz), v in sorted(vals.items()):
        acc = acc + v * xn[:, dy + 1, dz + 1 + hh]
    return acc, vals


def replay(op, plan, inv_taus, bh, dinvh, xh, emit_res):
    """csrc/mfree.cu mfree_chain_kernel on the tiled route, item by item:
    each block marches
    its tiles along x; step p (i0 - 1 .. i1) stores x*m and c of plane p
    (fetched the step before) into one of two ring slots, passes one
    barrier, reads a thread's neighbourhoods of plane p from the slot and
    adds plane p's taps to outputs p - 1 (then its epilogue and write), p
    and p + 1, in the op order of mfree_plain_h; tap sums, centre values
    and c of plane p - 1 pass to the next step in registers.  Window
    positions that the kernel does not fetch hold NaN, so a written node
    that read one would show.  Checks that every node is written once a
    level, that every read finds the plane it needs (ring slot, the c
    carried and each output's tap groups in order), that no store lands in
    a slot read since the last barrier, and that no level writes the
    buffer it reads."""
    NXn = op.dims[0]
    sx = op.strides[0]
    h, n = op.halo, op.n
    total = n + 2 * h
    m = op.m_h.to(torch.float32)
    c = op.c_h.to(torch.float32)
    k = len(inv_taus)
    slot = (plan.ty + 2) * plan.pitch
    bufs = {name: torch.full_like(xh, float("nan"))
            for name in ("out", "tmp", "res")}
    for v in bufs.values():
        v[:h] = 0.0
        v[n + h:] = 0.0
    bufs["x0"] = xh
    src = "x0"
    for r in range(1, k + int(emit_res) + 1):
        dst = _buf(r, k)
        assert dst != src, f"level {r} writes the buffer {src} it reads"
        x = bufs[src]
        xm_g = x * m
        writes = torch.zeros(total, dtype=torch.int64)
        barrier, rings = {}, {}
        for blk, tile, i0, i1 in _items(plan, NXn):
            T = _Tile(op, plan, tile)
            # a block's ring: [values, plane held, barrier count at the
            # last read] of the x*m slots 0, 1 and the c slots 2, 3
            ring = rings.setdefault(
                blk, [[torch.full((slot,), float("nan")), None, -1]
                      for _ in range(4)])
            barrier[blk] = barrier.get(blk, 0) + 1   # the segment's first

            def fetch(p):
                return (xm_g[T.goff + p * sx], c[T.goff + p * sx], p)

            # output plane -> [tap sums of the run's nodes, tap groups
            # done, centre values]; c carried from the step before, with its
            # plane
            outs, cp = {}, (None, None)
            F = fetch(i0 - 1)
            for p in range(i0 - 1, i1 + 1):
                s = p & 1
                for j, vals in ((s, F[0]), (2 + s, F[1])):
                    assert ring[j][2] < barrier[blk], \
                        f"slot {j} stored before a barrier after its read"
                    ring[j][0] = torch.full((slot,), float("nan"))
                    ring[j][0][T.sidx] = vals
                    ring[j][1] = F[2]
                barrier[blk] += 1
                if p < i1:
                    F = fetch(p + 1)
                assert ring[s][1] == p and ring[2 + s][1] == p
                ring[s][2] = ring[2 + s][2] = barrier[blk]
                xn = _nbr(ring[s][0], T.ws, plan.pitch, 3, RUN + 2)
                cn = _nbr(ring[2 + s][0], T.ws, plan.pitch, 2, RUN + 1)
                # output o, x-offset dx: plane p = o + dx; a corner l lies
                # in plane o - corner_x(l), here p or p - 1
                for o, dx in ((p - 1, 1), (p, 0), (p + 1, -1)):
                    if not i0 <= o < i1:
                        continue
                    st = outs.setdefault(o, [[torch.zeros(len(T.t0))] * RUN,
                                             0, {}])
                    assert st[1] == dx + 1, f"output {o}: taps out of order"
                    for hh in range(RUN):
                        def corner(l, hh=hh, o=o):
                            ax, ay, az = CORNERS[l]
                            if o - ax == p:
                                return cn[:, 1 - ay, 1 + hh - az]
                            assert cp[1] == o - ax == p - 1
                            return cp[0][:, 1 - ay, 1 + hh - az]

                        st[0][hh], vals = _taps(op, dx, hh, corner, xn,
                                                st[0][hh])
                        if dx == 0:
                            st[2][hh] = vals[(0, 0, 0)]
                    st[1] += 1
                    if dx < 1:
                        continue
                    t = T.t0 + o * sx
                    for hh in range(RUN):
                        tt = t + hh
                        mc, xc = m[tt], x[tt]
                        y = mc * st[0][hh] + (1.0 - mc) * (st[2][hh] * xc)
                        if r > k:
                            y = bh[tt] - y
                        else:
                            y = xc + dinvh[tt] * (bh[tt] - y) \
                                * inv_taus[r - 1]
                        keep = hh < T.nodes
                        bufs[dst][tt[keep]] = y[keep]
                        writes[tt[keep]] += 1
                    del outs[o]
                cp = (cn, p)
            assert not outs, "outputs left unfinished"
        assert torch.all(writes[h:h + n] == 1), f"level {r}"
        assert torch.all(writes[:h] == 0) and torch.all(writes[h + n:] == 0)
        src = dst if r <= k else src
    assert src == "out", f"the last root lands in {src}"
    return (bufs["out"], bufs["res"]) if emit_res else bufs["out"]


def _nbr(vals, at, stride, rows, cols):
    """[threads, rows, cols] of vals around offsets ``at``: rows from -1
    at ``stride`` apart, columns from -1 (a vector by flat offsets, or a
    ring slot by window indices)."""
    off = torch.tensor([[(dy - 1) * stride + kk - 1 for kk in range(cols)]
                        for dy in range(rows)])
    return vals[at[:, None, None] + off]


def _odd_op(dims, seed, dtype):
    """A random matrix-free operator on an odd node grid: coefficients,
    reference matrix and an essential-node mask from a numpy seed."""
    rng = np.random.default_rng(seed)
    nel = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    em0 = rng.uniform(-0.1, 0.1, (8, 8))
    em0 = em0 + em0.T + np.eye(8)
    ess = rng.choice(dims[0] * dims[1] * dims[2], 50, replace=False)
    return MatrixFreeQ1.build(rng.uniform(0.5, 2.0, nel), ess, em0, dims,
                              dtype)


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("roots", [1, 10])
@pytest.mark.parametrize("dims,sms", [((13, 17, 19), 132), ((9, 29, 31), 3),
                                      ((5, 37, 41), 1), ((5, 23, 193), 1),
                                      ((4, 39, 131), 2)])
def test_replay_equals_chain_plain(dims, sms, roots, emit_res):
    """The tiled route: one to twelve tiles a plane, ragged last tiles
    along z
    (9 x 29 x 31), along y and z (5 x 37 x 41, 4 x 39 x 131) and at NZn >
    127 (5 x 23 x 193, 4 x 39 x 131); blocks whose shares span several
    tiles (2 to 4 blocks) or a few planes of one (13 x 17 x 19 on 132
    SMs); f32 and bf16 fields: the replay equals the plain chain bit for
    bit."""
    taus = [0.9, 0.6, 1.1, 0.7, 0.8, 1.0, 0.5, 1.2, 0.65, 0.95][:roots]
    for dtype in (torch.float32, torch.bfloat16):
        op = _odd_op(dims, roots, dtype)
        plan = tiled_plan(dims, sms)
        for k, t, N in ((plan.ky, plan.ty, dims[1]),
                        (plan.kz, plan.tz, dims[2])):
            assert (k - 1) * t < N <= k * t
        rng = np.random.default_rng(5)
        x, b = (op.pad(torch.as_tensor(rng.standard_normal(op.n),
                                       dtype=torch.float32))
                for _ in range(2))
        d = op.pad(torch.as_tensor(rng.uniform(0.5, 1.0, op.n),
                                   dtype=torch.float32))
        got = replay(op, plan, taus, b, d, x, emit_res)
        ref = mfree_chain_plain(op, taus, b, d, x, emit_res)
        got, ref = (g if emit_res else (g,) for g in (got, ref))
        for g, w in zip(got, ref):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dims,shape,slots", [
    ((97, 97, 97), (14, 34, 7, 3), 9996),
    ((193, 193, 193), (18, 28, 11, 7), 38808),
    ((321, 321, 321), (14, 36, 23, 9), 104328)])
def test_mfree_plan_fills_one_wave(dims, shape, slots):
    """The tiled route at n=96, the capacity cell's n=192 and the
    full-capacity n=320 on 132 SMs: a tile shape with at most 6 % of its
    node slots past the grid, whose threads and windows fit a block; one
    wave of 3 x 132 blocks whose items (tiles x chunks of planes, one a
    block) cover every plane of every tile once, with fewer idle blocks
    than a chunk's tiles."""
    plan = tiled_plan(dims, 132)
    ty, tz, ky, kz = shape
    assert plan.route == "tiled" and plan[1:5] == shape
    assert ky * ty * kz * tz == slots
    assert dims[1] * dims[2] >= 0.94 * slots
    assert (tz // RUN) * ty <= THREADS
    assert (ty + 2) * (tz + 2) <= WINDOW * THREADS
    assert plan.blocks == 3 * 132
    assert plan.smem == 4 * 4 * (ty + 2) * (tz + 3)
    items = list(_items(plan, dims[0]))
    assert plan.blocks - plan.tiles < len(items) <= plan.blocks
    seen = torch.zeros(plan.tiles, dims[0], dtype=torch.int64)
    for _, tile, i0, i1 in items:
        seen[tile, i0:i1] += 1
    assert torch.all(seen == 1)


# -- the flat route ----------------------------------------------------------


def replay_flat(op, plan, inv_taus, bh, dinvh, xh, emit_res):
    """csrc/mfree.cu mfree_chain_kernel on the flat route, item by item:
    each item marches its range of FLAT flat positions over its chunk's
    planes through a ring of four x*m and three c planes, loading x*m
    plane ix + 1 and c plane ix at step ix and then computing plane ix's
    nodes from the ring alone, in the op order of mfree_plain_h.  Checks
    that every node is written once a level, that every read finds the
    plane it needs in the slot the kernel names, that no step loads into a
    slot the step before it read, and that no level writes the buffer it
    reads."""
    NXn = op.dims[0]
    sx, sy = op.strides
    h, n = op.halo, op.n
    total = n + 2 * h
    m = op.m_h.to(torch.float32)
    c = op.c_h.to(torch.float32)
    wx, wc = FLAT + 2 * sy + 2, FLAT + sy + 1
    k = len(inv_taus)
    bufs = {name: torch.full_like(xh, float("nan"))
            for name in ("out", "tmp", "res")}
    for v in bufs.values():
        v[:h] = 0.0
        v[n + h:] = 0.0
    bufs["x0"] = xh
    src = "x0"
    for r in range(1, k + int(emit_res) + 1):
        dst = _buf(r, k)
        assert dst != src, f"level {r} writes the buffer {src} it reads"
        x = bufs[src]
        writes = torch.zeros(total, dtype=torch.int64)
        for _, tile, i0, i1 in _items(plan, NXn):
            j0 = tile * FLAT
            ring_xm, ring_c = [None] * 4, [None] * 3
            held_xm, held_c = [None] * 4, [None] * 3

            def window(ix, width):
                gi = h + ix * sx + j0 - sy - 1 + torch.arange(width)
                return gi, (gi >= 0) & (gi < total)

            def load_xm(ix):
                gi, ok = window(ix, wx)
                g = gi.clamp(0, total - 1)
                ring_xm[(ix + 1) % 4] = torch.where(ok, x[g] * m[g], 0.0)
                held_xm[(ix + 1) % 4] = ix
                return (ix + 1) % 4

            def load_c(ix):
                gi, ok = window(ix, wc)
                g = gi.clamp(0, total - 1)
                ring_c[(ix + 1) % 3] = torch.where(ok, c[g], 0.0)
                held_c[(ix + 1) % 3] = ix
                return (ix + 1) % 3

            load_xm(i0 - 1)
            load_xm(i0)
            load_c(i0 - 1)
            read = (set(), set())
            for ix in range(i0, i1):
                wrote = (load_xm(ix + 1), load_c(ix))
                assert wrote[0] not in read[0] and wrote[1] not in read[1]
                read = (set(), set())
                jj = j0 + torch.arange(FLAT)
                keep = jj < sx
                t = h + ix * sx + jj[keep]
                w = torch.arange(FLAT)[keep] + sy + 1
                cl = []
                for ax, ay, az in CORNERS:
                    slot = (ix - ax + 1) % 3
                    assert held_c[slot] == ix - ax
                    read[1].add(slot)
                    cl.append(ring_c[slot][w - ay * sy - az])
                vals = {}
                for l, (ax, ay, az) in enumerate(CORNERS):
                    for lp, (bx, by, bz) in enumerate(CORNERS):
                        key = (bx - ax, by - ay, bz - az)
                        term = op.K[l][lp] * cl[l]
                        vals[key] = term if key not in vals \
                            else vals[key] + term
                acc = torch.zeros(len(t), dtype=torch.float32)
                for (dx, dy, dz), v in sorted(vals.items()):
                    slot = (ix + dx + 1) % 4
                    assert held_xm[slot] == ix + dx
                    read[0].add(slot)
                    acc += v * ring_xm[slot][w + dy * sy + dz]
                mc, xc = m[t], x[t]
                y = mc * acc + (1.0 - mc) * (vals[(0, 0, 0)] * xc)
                if r > k:
                    y = bh[t] - y
                else:
                    y = xc + dinvh[t] * (bh[t] - y) * inv_taus[r - 1]
                bufs[dst][t] = y
                writes[t] += 1
        assert torch.all(writes[h:h + n] == 1), f"level {r}"
        assert torch.all(writes[:h] == 0) and torch.all(writes[h + n:] == 0)
        src = dst if r <= k else src
    assert src == "out", f"the last root lands in {src}"
    return (bufs["out"], bufs["res"]) if emit_res else bufs["out"]


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("roots", [1, 10])
@pytest.mark.parametrize("dims,sms", [((13, 17, 19), 132), ((9, 29, 31), 3),
                                      ((5, 37, 41), 1)])
def test_flat_replay_equals_chain_plain(dims, sms, roots, emit_res):
    """The flat route: one to three ranges a plane (ragged last ranges),
    one to thirteen chunks, blocks that run several items (5 x 37 x 41 on
    one SM), f32 and bf16 fields: the replay equals the plain chain bit
    for bit."""
    taus = [0.9, 0.6, 1.1, 0.7, 0.8, 1.0, 0.5, 1.2, 0.65, 0.95][:roots]
    for dtype in (torch.float32, torch.bfloat16):
        op = _odd_op(dims, roots, dtype)
        plan = flat_plan(dims, sms)
        assert plan.tiles == -(-dims[1] * dims[2] // FLAT)
        rng = np.random.default_rng(5)
        x, b = (op.pad(torch.as_tensor(rng.standard_normal(op.n),
                                       dtype=torch.float32))
                for _ in range(2))
        d = op.pad(torch.as_tensor(rng.uniform(0.5, 1.0, op.n),
                                   dtype=torch.float32))
        got = replay_flat(op, plan, taus, b, d, x, emit_res)
        ref = mfree_chain_plain(op, taus, b, d, x, emit_res)
        got, ref = (g if emit_res else (g,) for g in (got, ref))
        for g, w in zip(got, ref):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dims,l2,route", [
    ((97, 97, 97), None, "flat"), ((193, 193, 193), None, "tiled"),
    ((321, 321, 321), None, "tiled"), ((13, 17, 19), None, "flat"),
    ((5, 23, 193), None, "tiled"), ((121, 121, 121), None, "tiled"),
    ((97, 97, 97), 20 * 2 ** 20, "tiled")])
def test_mfree_plan_route(dims, l2, route):
    """The route from the dims: flat where a level's working set fits the
    L2 (50 MB on an H100, or the ``l2_bytes`` given) and NZn <= 127, else
    tiled (n=192, a grid with NZn > 127, 121^3 nodes at ~57 MB); the plan
    is that route's own."""
    kw = {} if l2 is None else {"l2_bytes": l2}
    plan = mfree_plan(dims, 132, **kw)
    assert plan.route == route
    assert plan == (flat_plan if route == "flat" else tiled_plan)(dims, 132)
    fits = (np.prod(dims) + 2 * q1_halo(dims)) * NODE_BYTES \
        <= (l2 or 50 * 2 ** 20)
    assert (route == "flat") == (fits and dims[2] <= 127)


def test_flat_plan_fills_one_wave():
    """The flat route at n=96 (97^3 nodes) on 132 SMs: 19 ranges a plane,
    20 chunks of 4 or 5 planes, 380 items within the 3 x 132 resident
    blocks; a grid past NZn = 127 is refused."""
    plan = flat_plan((97, 97, 97), 132)
    assert plan.tiles == 19 and plan.blocks == 3 * 132
    assert plan.smem == 4 * (4 * (FLAT + 196) + 3 * (FLAT + 98))
    items = list(_items(plan, 97))
    assert len(items) == 380
    assert {i1 - i0 for _, _, i0, i1 in items} == {4, 5}
    with pytest.raises(ValueError, match="flat route"):
        flat_plan((5, 23, 193), 132)
