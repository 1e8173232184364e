"""The port's device formats (ops/sparse.py: ELL, DIA, banded,
device_matrix, RCM; ops/blockrow.py) against the JAX package's on the
matrices of tests/test_formats.py, in f64 at rtol 1e-12."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from saamge_tpu.fem import assemble  # noqa: E402
from saamge_tpu.fem.mesh import hex_mesh  # noqa: E402
from saamge_tpu.ops import blockrow as JB  # noqa: E402
from saamge_tpu.ops import sparse as JS  # noqa: E402

from saamge_tpu_torch.ops import sparse as S  # noqa: E402
from saamge_tpu_torch.ops.blockrow import (BlockRow,  # noqa: E402
                                           TransposedBlockRow)

torch.set_num_threads(1)
F64 = torch.float64


def _band_matrix(n=100, bw=5, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.standard_normal(n - abs(k)) for k in range(-bw, bw + 1)],
                 offsets=list(range(-bw, bw + 1)), format="csr")
    return A.tocsr()


def _scattered():
    return (sp.random(300, 300, density=0.02, random_state=0, format="csr")
            + sp.identity(300)).tocsr()


def _block_matrix(disjoint=False):
    """Row groups with random column sets; ``disjoint``: the sets are
    disjoint, as a tentative restriction's are (some columns in none)."""
    rng = np.random.default_rng(0)
    n = 90
    offsets = np.array([0, 5, 5, 17, 30, 58, 90])
    perm = np.random.default_rng(1).permutation(n)
    rows, cols, vals = [], [], []
    for g in range(len(offsets) - 1):
        r0, r1 = offsets[g], offsets[g + 1]
        colset = rng.choice(n, size=rng.integers(3, 25), replace=False)
        if disjoint:
            colset = perm[14 * g:14 * g + min(len(colset), 14)]
        for r in range(r0, r1):
            for c in colset:
                rows.append(r)
                cols.append(c)
                vals.append(rng.standard_normal())
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr(), offsets


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(ref)).max())


def _x(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def test_ell_matches_jax():
    A = sp.random(50, 70, density=0.15, random_state=0).tocsr()
    x = _x(70)
    ell = S.ELL.from_csr(A, F64)
    jell = JS.DeviceELL.from_csr(A, dtype=jnp.float64)
    assert np.array_equal(ell.cols.numpy(), np.asarray(jell.cols))
    y = ell.matvec(torch.as_tensor(x)).numpy()
    _close(y, JS.ell_spmv(jell, jnp.asarray(x)))
    _close(y, A @ x)


def test_dia_matches_jax():
    A = assemble.build_discrete_problem(hex_mesh(5), coef=1.0)[0]
    dia = S.DIA.try_from_csr(A, F64)
    jdia = JS.DeviceDIA.try_from_csr(A, dtype=jnp.float64)
    assert dia.offsets == jdia.offsets and len(dia.offsets) == 27
    assert np.array_equal(dia.vals.numpy(), np.asarray(jdia.vals))
    x = _x(A.shape[0], 2)
    y = S.dia_spmv(dia, torch.as_tensor(x)).numpy()
    _close(y, JS.dia_spmv(jdia, jnp.asarray(x)))
    _close(y, A @ x)


def test_dia_max_diags_rule():
    """41+ distinct diagonals: try_from_csr gives None (JAX: None),
    from_csr raises."""
    A = _band_matrix(200, 45)
    assert JS.DeviceDIA.try_from_csr(A) is None
    assert S.DIA.try_from_csr(A) is None
    with pytest.raises(ValueError):
        S.DIA.from_csr(A, max_diags=40)
    assert S.DIA.try_from_csr(_band_matrix(200, 19)) is not None


def test_banded_matches_jax():
    A = _band_matrix(123, 7)
    band = S.Banded.try_from_csr(A, F64)
    jband = JS.DeviceBanded.try_from_csr(A, dtype=jnp.float64)
    assert band.lo == jband.lo
    assert np.array_equal(band.blocks.numpy(), np.asarray(jband.blocks))
    x = _x(123)
    y = band.matvec(torch.as_tensor(x)).numpy()
    _close(y, jband.matvec(jnp.asarray(x)))
    _close(y, A @ x)


def test_banded_fill_guard():
    n = 256
    A = sp.lil_matrix((n, n))
    A.setdiag(2.0)
    A[0, :] = 1.0
    A[:, 0] = 1.0
    assert S.Banded.try_from_csr(A.tocsr(), max_fill=8.0) is None


@pytest.mark.parametrize("case", ["stencil", "wide_band", "scattered"])
def test_device_matrix_selection_matches_jax(case):
    A, kw = {"stencil": (_band_matrix(200, 2), {}),
             "wide_band": (_band_matrix(400, 45), {}),
             "scattered": (_scattered(), {"banded_max_fill": 2.0})}[case]
    names = {"DIA": "DeviceDIA", "Banded": "DeviceBanded",
             "ELL": "DeviceELL"}
    M = S.device_matrix(A, F64, **kw)
    J = JS.device_matrix(A, jnp.float64, **kw)
    assert names[type(M).__name__] == type(J).__name__
    x = _x(A.shape[0], 3)
    xt = torch.as_tensor(x)
    y = S.dia_spmv(M, xt) if isinstance(M, S.DIA) else M.matvec(xt)
    _close(y.numpy(), J.matvec(jnp.asarray(x)))


def test_rcm_matches_jax():
    A = _band_matrix(200, 4)
    perm = np.random.default_rng(0).permutation(200)
    Ashuf = A[np.ix_(perm, perm)].tocsr()
    p = S.rcm_permutation(Ashuf)
    assert np.array_equal(p, JS.rcm_permutation(Ashuf))
    Aback = Ashuf[np.ix_(p, p)].tocoo()
    assert np.abs(Aback.col - Aback.row).max() <= 3 * 4 + 2


def test_blockrow_matches_jax():
    A, offsets = _block_matrix()
    B = BlockRow.from_csr(A, offsets, F64)
    J = JB.DeviceBlockRow.from_csr(A, offsets, dtype=jnp.float64)
    assert [tuple(b.shape) for b, _, _ in B.buckets()] == \
        [tuple(b.blocks.shape) for b in J.buckets]
    x, y = _x(90, 4), _x(90, 5)
    got = B.matvec(torch.as_tensor(x)).numpy()
    _close(got, J.matvec(jnp.asarray(x)))
    _close(got, A @ x)
    # the bucket product sums overlapping column sets, as JAX's does; the
    # transpose writes each column from one group: overlapping column
    # sets are refused, disjoint ones (a tentative restriction's) taken
    got = B.bucket_rmatvec(torch.as_tensor(y)).numpy()
    _close(got, JB.TransposedBlockRow(J).matvec(jnp.asarray(y)))
    _close(got, A.T @ y)
    with pytest.raises(ValueError, match="overlap"):
        TransposedBlockRow(B)
    A, offsets = _block_matrix(disjoint=True)
    B = BlockRow.from_csr(A, offsets, F64)
    J = JB.DeviceBlockRow.from_csr(A, offsets, dtype=jnp.float64)
    got = TransposedBlockRow(B).matvec(torch.as_tensor(y)).numpy()
    _close(got, JB.TransposedBlockRow(J).matvec(jnp.asarray(y)))
    _close(got, A.T @ y)
    assert TransposedBlockRow(B).shape == (90, 90)
