"""Port matrix-free Q1 operator (saamge_tpu_torch/ops/mfree.py) against
the JAX Pallas kernel (pallas_mfree.MatrixFreeQ1, interpret mode, flat
layout) and against the stored DIA of the assembled operator, at n=8 and
n=16 with the same numpy-seeded vectors; the chain against the JAX
package's loop of root and residual passes; and the kernel's tile
schedule replayed on the CPU.  On the CPU the wrappers run their plain
torch versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.fem import assemble
from saamge_tpu.fem.mesh import hex_mesh
from saamge_tpu.ops.pallas_mfree import MatrixFreeQ1 as JaxMatrixFreeQ1
from saamge_tpu.ops.pallas_stencil import PallasDIA
from saamge_tpu.ops.sparse import DeviceDIA

from saamge_tpu_torch.ops.mfree import (CORNERS, NODES, MatrixFreeQ1,
                                        mfree_chain, mfree_chain_plain,
                                        mfree_h, mfree_plan)
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


def replay(op, plan, inv_taus, bh, dinvh, xh, emit_res):
    """csrc/mfree.cu mfree_chain_kernel, item by item: each item marches
    its tile over its chunk's planes through a ring of four x*m and three
    c planes, loading x*m plane ix + 1 and c plane ix at step ix and then
    computing plane ix's nodes from the ring alone, in the op order of
    mfree_plain_h.  Checks that every node is written once a level, that
    every read finds the plane it needs in the slot the plan names, that
    no step loads into a slot the step before it read, and that no level
    writes the buffer it reads."""
    NXn = op.dims[0]
    sx, sy = op.strides
    h, n = op.halo, op.n
    total = n + 2 * h
    m = op.m_h.to(torch.float32)
    c = op.c_h.to(torch.float32)
    wx, wc = NODES + 2 * sy + 2, NODES + sy + 1
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
        for item in range(plan.items):
            tile, chunk = item % plan.tiles, item // plan.tiles
            j0, i0 = tile * NODES, chunk * plan.planes
            i1 = min(NXn, i0 + plan.planes)
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
                jj = j0 + torch.arange(NODES)
                keep = jj < sx
                t = h + ix * sx + jj[keep]
                w = torch.arange(NODES)[keep] + sy + 1
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
                                      ((5, 37, 41), 1)])
def test_replay_equals_chain_plain(dims, sms, roots, emit_res):
    """One to three tiles a plane (ragged last tiles), one to thirteen
    chunks, f32 and bf16 fields: the replay equals the plain chain bit
    for bit."""
    taus = [0.9, 0.6, 1.1, 0.7, 0.8, 1.0, 0.5, 1.2, 0.65, 0.95][:roots]
    for dtype in (torch.float32, torch.bfloat16):
        op = _odd_op(dims, roots, dtype)
        plan = mfree_plan(dims, sms)
        assert plan.tiles == -(-dims[1] * dims[2] // NODES)
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


def test_mfree_plan_fills_one_wave():
    """n=96 (97^3 nodes) on 132 SMs: 19 tiles a plane, chunks of 5
    planes, 380 items within the 3 x 132 resident blocks."""
    plan = mfree_plan((97, 97, 97), 132)
    assert (plan.tiles, plan.planes, plan.chunks) == (19, 5, 20)
    assert plan.items <= 3 * 132
    assert plan.smem == 4 * (4 * (NODES + 196) + 3 * (NODES + 98))
