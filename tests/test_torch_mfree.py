"""Port matrix-free Q1 operator (saamge_tpu_torch/ops/mfree.py) against
the JAX Pallas kernel (pallas_mfree.MatrixFreeQ1, interpret mode, flat
layout) and against the stored DIA of the assembled operator, at n=8 and
n=16 with the same numpy-seeded vectors.  On the CPU the wrapper runs
its plain torch version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.fem import assemble
from saamge_tpu.fem.mesh import hex_mesh
from saamge_tpu.ops.pallas_mfree import MatrixFreeQ1 as JaxMatrixFreeQ1
from saamge_tpu.ops.pallas_stencil import PallasDIA
from saamge_tpu.ops.sparse import DeviceDIA

from saamge_tpu_torch.ops.mfree import MatrixFreeQ1, mfree_h
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
