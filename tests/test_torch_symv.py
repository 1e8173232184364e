"""The general path's coarsest solve: the explicit inverse of the SPD
coarsest operator, packed as lower-triangle tiles (ops/symv.pack_lower,
solve/compiled.coarse_inverse) and applied by one product
(ops/symv.symv; on the CPU its plain version, which repeats the order of
csrc/symv.cu).  Held to dense f64 solves (scipy ``cho_solve``) by the
forward error bound of the product: the stored inverse rounded once to
the working precision u and each output an n-term sum in it, so
|y - A^-1 b| <= (n + 2) u (|A^-1| |b|) componentwise, plus the f64
inversion's own error, at most n kappa(A) u64 on the same scale.
Imports no JAX."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from saamge_tpu_torch import compile_hierarchy, elasticity_problem
from saamge_tpu_torch.api import SpectralAMGSolver, checkerboard_coef
from saamge_tpu_torch.config import SolverOptions
from saamge_tpu_torch.fem import assemble
from saamge_tpu_torch.fem.mesh import quad_mesh
from saamge_tpu_torch.ops.symv import (TILE, pack_lower, symv, symv_plain,
                                       tile_rows)
from saamge_tpu_torch.solve import compiled as C
from saamge_tpu_torch.utils.logging import TIMERS

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
U = {F32: 2.0 ** -24, F64: 2.0 ** -53}
SIZES = (1, 5, 127, 128, 129, 367, 700)


def spd(n, seed=0, lo=1.0, hi=4.0):
    """A dense f64 SPD matrix with eigenvalues in [lo, hi], exactly
    symmetric."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * rng.uniform(lo, hi, n)) @ Q.T
    return (M + M.T) / 2


def unpack(tiles, n):
    """The dense n x n matrix of a lower-triangle packing."""
    nt = tile_rows(n)
    M = torch.zeros(nt * TILE, nt * TILE, dtype=tiles.dtype)
    for t, (i, j) in enumerate(torch.tril_indices(nt, nt).T.tolist()):
        blk = tiles[t]
        M[i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE] = blk
        M[j * TILE:(j + 1) * TILE, i * TILE:(i + 1) * TILE] = blk.T
    assert not M[n:].any() and not M[:, n:].any()
    return M[:n, :n]


def assert_within_bound(y, A, b, dtype):
    """|y - A^-1 b| within the product's forward error bound (module
    docstring), A dense f64 and b f64."""
    n = A.shape[0]
    X = np.linalg.inv(A)
    ref = sla.cho_solve(sla.cho_factor(A, lower=True), b)
    scale = np.abs(X) @ np.abs(b)
    tol = ((n + 2) * U[dtype] + n * np.linalg.cond(A) * U[F64]) * scale
    err = np.abs(y.double().numpy() - ref)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [1, 129, 300])
def test_packing_round_trip(n, dtype):
    """Unpacked, the tiles are the dense matrix exactly and symmetric;
    nt (nt + 1) / 2 tiles, zero past n; ``symv.bytes`` counts them."""
    M = torch.as_tensor(spd(n, n), dtype=dtype)
    before = TIMERS.counters.get("symv.bytes", 0)
    tiles = pack_lower(M)
    nt = tile_rows(n)
    assert tiles.shape == (nt * (nt + 1) // 2, TILE, TILE)
    assert TIMERS.counters["symv.bytes"] - before == \
        tiles.numel() * tiles.element_size()
    dense = unpack(tiles, n)
    assert torch.equal(dense, M) and torch.equal(dense, dense.T)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", SIZES)
def test_symv_plain_applies_the_inverse(n, dtype):
    """The packed inverse of a Cholesky factor (formed in f64, rounded to
    ``dtype``) applied by ``symv_plain`` is A^-1 b within the bound, for
    one tile, ragged tile rows and whole ones."""
    A = spd(n, 10 + n)
    b = np.random.default_rng(n).standard_normal(n)
    tiles = C.coarse_inverse(torch.as_tensor(np.linalg.cholesky(A)), dtype,
                             "cpu")
    assert tiles.dtype == dtype
    y = symv_plain(tiles, torch.as_tensor(b, dtype=dtype))
    assert y.dtype == dtype and y.shape == (n,)
    assert_within_bound(y, A, b, dtype)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_two_calls_are_bit_equal(dtype):
    """A fixed order of sums: two calls give the same bits."""
    n = 367
    tiles = pack_lower(torch.as_tensor(np.linalg.inv(spd(n)), dtype=dtype))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(n),
                        dtype=dtype)
    assert torch.equal(symv(tiles, x), symv(tiles, x))


def _three_level():
    """The quad_mesh(20) 3-level setup of tests/test_torch_compiled.py."""
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    s = SpectralAMGSolver(A, mesh, em, SolverOptions(
        correct_nulspace=False, num_levels=3, first_elems_per_agg=16,
        elems_per_agg=4), ess_attr_marker=ess)
    return s.ml


def _elasticity():
    """The n=8 elasticity setup of tests/test_torch_elasticity.py."""
    return elasticity_problem(
        n=8, contrast=2.0, seed=2 ** 31 + 9, first_elems_per_agg=32,
        elems_per_agg=8, device_setup=True, device="cpu")[0]


@pytest.fixture(scope="module", params=["three_level", "elasticity"])
def setup(request):
    return {"three_level": _three_level, "elasticity": _elasticity}[
        request.param]()


@pytest.mark.parametrize("dtype", [F32, F64])
def test_coarse_solve_is_cho_solve(setup, dtype):
    """``compile_hierarchy``'s coarse_solve against scipy's f64
    ``cho_solve`` with the coarsest operator, within the bound."""
    Ac = setup.levels[-1].tg_data.Ac.toarray()
    h = compile_hierarchy(setup, dtype, device="cpu")
    assert h.coarse_n == Ac.shape[0]
    b = np.random.default_rng(4).standard_normal(h.coarse_n)
    y = C.coarse_solve(h, torch.as_tensor(b, dtype=dtype))
    assert_within_bound(y, Ac, b, dtype)


def test_counters_one_product_a_coarsest_visit(setup):
    """``symv.bytes`` counts the compile's packing; on the CPU every
    coarsest visit is one plain product and no launch: one a V-cycle,
    mu^(levels - 1) a W-cycle."""
    TIMERS.reset()
    h = compile_hierarchy(setup, F32, device="cpu")
    assert TIMERS.counters["symv.bytes"] == \
        h.coarse_inv.numel() * h.coarse_inv.element_size()
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(h.n),
                        dtype=F32)
    C.vcycle_apply(h, r, graph=False)
    assert TIMERS.counters.get("symv.plain") == 1
    C.vcycle(h, r, torch.zeros_like(r), mu=2)
    assert TIMERS.counters.get("symv.plain") == 1 + 2 ** (len(h.levels))
    assert "symv.kernel" not in TIMERS.counters
