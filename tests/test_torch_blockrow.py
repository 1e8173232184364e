"""The block-row kernel's packing and its plain version
(saamge_tpu_torch/ops/blockrow.py): the packing that ``BlockRow`` builds
from its buckets, by ``from_csr`` and by the converter from the JAX
package's ``DeviceBlockRow``, against the CSR matrix it came from;
``blockrow_plain`` in every mode against the bucket products, scipy and
the plain root chain, in f32 and f64, and against a loop written out in
the kernel's order, bit for bit; the buffers under ``.to()`` and
``deepcopy``; the counters ``blockrow.plain`` / ``blockrow.kernel``.
Meshes: the quad_mesh(20) three-level fixture of tests/test_compiled.py
and hexkway at n=10 (generic k-way agglomerates of 64 elements)."""

import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from saamge_tpu.solve import compiled as JC  # noqa: E402

from saamge_tpu_torch.api import (SpectralAMGSolver,  # noqa: E402
                                  checkerboard_coef, general_problem)
from saamge_tpu_torch.config import SolverOptions  # noqa: E402
from saamge_tpu_torch.convert import from_jax_compiled  # noqa: E402
from saamge_tpu_torch.fem import assemble  # noqa: E402
from saamge_tpu_torch.fem.mesh import quad_mesh  # noqa: E402
from saamge_tpu_torch.ops.blockrow import (BlockRow,  # noqa: E402
                                           TransposedBlockRow, blockrow,
                                           blockrow_plain)
from saamge_tpu_torch.solve import compiled as C  # noqa: E402
from saamge_tpu_torch.utils.logging import TIMERS  # noqa: E402

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
PROBLEMS = ("three_level", "hexkway")
# relative tolerance of a product in another sum order, by dtype
TOL = {F32: 1e-5, F64: 1e-12}


def _setup(problem):
    if problem == "hexkway":
        return general_problem(n=10, elems_per_agg=64)[0]
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    return SpectralAMGSolver(
        A, mesh, em, SolverOptions(correct_nulspace=False, num_levels=3,
                                   first_elems_per_agg=16, elems_per_agg=4),
        ess_attr_marker=ess).ml


@pytest.fixture(scope="module")
def setups():
    return {p: _setup(p) for p in PROBLEMS}


def _operators(ml):
    """[(name, CSR matrix, group offsets)] of every block-row operator
    compile_hierarchy builds: each coarse operator numbered by the finer
    level's MIS offsets, each tentative restriction."""
    out = []
    for i, level in enumerate(ml.levels):
        tg = level.tg_data
        if i > 0:
            offs = ml.levels[i - 1].tg_data.interp_data.mis_coarsedofoffsets
            out.append((f"A{i}", level.A, np.asarray(offs, np.int64)))
        if not tg.smooth_interp:
            offs = tg.interp_data.mis_coarsedofoffsets
            out.append((f"R{i}", tg.restr, np.asarray(offs, np.int64)))
    return out


def _decode(M):
    """{row0: (nr, columns, (nr, nc) values)} of M's packing, checking the
    offsets (back to back in descriptor order) and longest-first order."""
    d = M.packed_desc.numpy().astype(np.int64)
    row0, nr, nc, voff, coff = d.T
    length = nr * nc
    assert np.array_equal(voff, np.cumsum(length) - length)
    assert np.array_equal(coff, np.cumsum(nc) - nc)
    assert np.all(np.diff(length) <= 0)
    assert M.packed_vals.shape == (length.sum(),)
    assert M.packed_cols.shape == (nc.sum(),)
    assert M.packed_desc.dtype == M.packed_cols.dtype == torch.int32
    vals, cols = M.packed_vals.numpy(), M.packed_cols.numpy()
    return {int(r0): (int(a), cols[c0:c0 + b], vals[v0:v0 + a * b]
                      .reshape(a, b))
            for r0, a, b, v0, c0 in zip(row0, nr, nc, voff, coff)}


@pytest.mark.parametrize("problem", PROBLEMS)
def test_packing_from_csr(setups, problem):
    ops = _operators(setups[problem])
    assert [name for name, _, _ in ops][:2] == ["R0", "A1"]
    for name, A, offs in ops:
        M = BlockRow.from_csr(A, offs, F64)
        groups = _decode(M)
        A = A.tocsr()
        want = {int(r0): r1 - r0 for r0, r1 in zip(offs[:-1], offs[1:])
                if r1 > r0}
        assert {r0: g[0] for r0, g in groups.items()} == want, name
        for r0, (nr, cols, vals) in groups.items():
            sub = A[r0:r0 + nr]
            assert np.array_equal(cols, np.unique(sub.indices)), name
            np.testing.assert_array_equal(vals, sub[:, cols].toarray())
        # R's column sets partition some of the fine dofs: the transpose
        # writes each covered column once and the others 0
        if name.startswith("R"):
            assert M.disjoint
            covered = np.concatenate([g[1] for g in groups.values()])
            assert np.array_equal(np.sort(np.concatenate(
                [covered, M.uncovered_cols.numpy()])), np.arange(A.shape[1]))
            TransposedBlockRow(M)
        else:
            assert not M.disjoint
            with pytest.raises(ValueError, match="overlap"):
                TransposedBlockRow(M)


def test_packing_of_the_converter(setups):
    """The converter's BlockRows (from the JAX package's buckets) pack
    exactly as from_csr's of the same matrices."""
    ml = setups["three_level"]
    hc = from_jax_compiled(JC.compile_hierarchy(ml, dtype=jnp.float64))
    h = C.compile_hierarchy(ml, F64, device="cpu")
    pairs = [(hc.levels[1].A, h.levels[1].A), (hc.levels[0].R, h.levels[0].R),
             (hc.levels[0].P.base, h.levels[0].P.base)]
    for got, ref in pairs:
        assert isinstance(got, BlockRow)
        for name in ("packed_vals", "packed_cols", "packed_desc",
                     "uncovered_cols"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert got.disjoint == ref.disjoint


def test_packing_raises_on_a_misplaced_row():
    A = sp.random(12, 30, density=0.3, random_state=0, format="csr")
    M = BlockRow.from_csr(A, np.array([0, 3, 7, 12]), F64)
    rows = M.gather_rows.clone()
    rows[[0, 1]] = rows[[1, 0]]
    with pytest.raises(ValueError, match="row0"):
        BlockRow(list(M.buckets()), rows, M.shape)


def _vectors(n, m, dtype, seed):
    rng = np.random.default_rng(seed)
    x, y = (torch.as_tensor(rng.standard_normal(k)).to(dtype)
            for k in (m, n))
    b = torch.as_tensor(rng.standard_normal(n)).to(dtype)
    dinv = torch.as_tensor(rng.uniform(0.5, 1.0, n)).to(dtype)
    return x, y, b, dinv


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_plain_modes(setups, problem, dtype):
    tau = C._cast_floats([1.37], dtype)[0]
    for name, A, offs in _operators(setups[problem]):
        M = BlockRow.from_csr(A, offs, dtype)
        n, m = M.shape
        x, y, b, dinv = _vectors(n, m, dtype, 3)
        ax = blockrow_plain(M, x)
        assert _rel(ax, M.bucket_matvec(x)) <= TOL[dtype], name
        assert _rel(ax.double(), torch.as_tensor(A @ x.double().numpy())) \
            <= TOL[dtype], name
        if n == m:
            ref = x + (dinv * (b - M.bucket_matvec(x))) / tau
            assert _rel(blockrow_plain(M, x, "root", b, dinv, tau), ref) \
                <= TOL[dtype], name
            assert _rel(blockrow_plain(M, x, "residual", b),
                        b - M.bucket_matvec(x)) <= TOL[dtype], name
        if M.disjoint:
            aty = blockrow_plain(M, y, "transpose")
            assert _rel(aty, M.bucket_rmatvec(y)) <= TOL[dtype], name
            assert _rel(aty.double(), torch.as_tensor(
                A.T @ y.double().numpy())) <= TOL[dtype], name


def _kernel_order(M, x, mode):
    """The kernel's sums written out as loops: a group's lane l adds its
    columns l, l + 32, ... in turn, then the xor butterfly; the transpose
    adds a column's rows in turn."""
    n, m = M.shape
    y = torch.zeros(m if mode == "transpose" else n, dtype=x.dtype)
    vals, cols = M.packed_vals, M.packed_cols.long()
    for row0, nr, nc, v0, c0 in M.packed_desc.tolist():
        V = vals[v0:v0 + nr * nc].view(nr, nc)
        cg = cols[c0:c0 + nc]
        if mode == "transpose":
            for c in range(nc):
                acc = torch.zeros((), dtype=x.dtype)
                for r in range(nr):
                    acc = acc + V[r, c] * x[row0 + r]
                y[cg[c]] = acc
            continue
        for r in range(nr):
            lane = torch.zeros(32, dtype=x.dtype)
            for c in range(nc):
                lane[c % 32] = lane[c % 32] + V[r, c] * x[cg[c]]
            for o in (16, 8, 4, 2, 1):
                lane = lane + lane[torch.arange(32) ^ o]
            y[row0 + r] = lane[0]
    return y


@pytest.mark.parametrize("mode", ["spmv", "transpose"])
def test_plain_is_the_kernel_order(mode):
    """Groups of 1 to 11 rows (more than the kernel's 8 at once) and 1 to
    75 columns (three lane passes), disjoint columns; f32, bit for bit."""
    rng = np.random.default_rng(5)
    sizes = [(1, 1), (11, 75), (3, 40), (8, 33), (2, 5), (1, 64)]
    m = sum(c for _, c in sizes) + 7
    perm = rng.permutation(m)
    rows, cols, vals, offs, c0 = [], [], [], [0], 0
    for nr, nc in sizes:
        for r in range(offs[-1], offs[-1] + nr):
            for c in perm[c0:c0 + nc]:
                rows.append(r)
                cols.append(c)
                vals.append(rng.standard_normal())
        offs.append(offs[-1] + nr)
        c0 += nc
    A = sp.coo_matrix((vals, (rows, cols)), shape=(offs[-1], m)).tocsr()
    M = BlockRow.from_csr(A, np.array(offs), F32)
    assert M.disjoint and M.max_rows == 11 and M.max_cols == 75
    x = torch.as_tensor(rng.standard_normal(
        offs[-1] if mode == "transpose" else m), dtype=F32)
    assert torch.equal(blockrow_plain(M, x, mode), _kernel_order(M, x, mode))


def test_buffers_follow_to_and_deepcopy(setups):
    h = C.compile_hierarchy(setups["hexkway"], F32, device="cpu")
    M = h.levels[1].A
    names = ("packed_vals", "packed_cols", "packed_desc", "uncovered_cols")
    bufs = dict(M.named_buffers())
    assert set(names) <= set(bufs)
    c = copy.deepcopy(h).levels[1].A
    for name in names:
        assert torch.equal(getattr(c, name), bufs[name])
        assert getattr(c, name) is not bufs[name]
    assert (c.disjoint, c.max_rows, c.max_cols) == \
        (M.disjoint, M.max_rows, M.max_cols)
    h64 = copy.deepcopy(h).to(F64)
    assert h64.levels[1].A.packed_vals.dtype == F64
    assert h64.levels[1].A.packed_desc.dtype == torch.int32
    meta = copy.deepcopy(h).to("meta")
    for lv in meta.levels:
        for mod in (lv.A_mod, lv.R):
            if isinstance(mod, BlockRow):
                assert all(getattr(mod, n).device.type == "meta"
                           for n in names)


def _grown(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("problem", PROBLEMS)
def test_counters(setups, problem):
    """On the CPU every block-row product of a V-cycle is one count of
    ``blockrow.plain`` and none of ``blockrow.kernel``: each root and
    the residual on a block-row operator, each block-row R and P; its
    coarsest solve is one count of ``symv.plain``."""
    h = C.compile_hierarchy(setups[problem], F64, device="cpu")
    per_cycle = 0
    for lv in h.levels:
        if isinstance(lv.A, BlockRow):
            per_cycle += 2 * len(lv.roots) + 1
        per_cycle += isinstance(lv.R, BlockRow)
        per_cycle += isinstance(lv.P, TransposedBlockRow)
    assert per_cycle >= 3
    before = dict(TIMERS.counters)
    C.vcycle_apply(h, torch.ones(h.n, dtype=F64))
    assert _grown(TIMERS.counters, before) == {"blockrow.plain": per_cycle,
                                               "symv.plain": 1}
    before = dict(TIMERS.counters)
    M = h.levels[0].R
    blockrow(M, torch.ones(M.shape[1], dtype=F64))
    M.rmatvec(torch.ones(M.shape[0], dtype=F64))
    assert _grown(TIMERS.counters, before) == {"blockrow.plain": 2}


def test_modes_refused():
    A = sp.random(12, 30, density=0.3, random_state=0, format="csr")
    M = BlockRow.from_csr(A, np.array([0, 3, 7, 12]), F64)
    x = torch.ones(30, dtype=F64)
    with pytest.raises(ValueError, match="root"):
        blockrow(M, x, "root", torch.ones(12, dtype=F64),
                 torch.ones(12, dtype=F64), 1.0)
    with pytest.raises(ValueError):
        blockrow(M, x, "scatter")
