"""The general path's fused smoother (ops/smoother.py; on the CPU its
plain version) against the JAX fused Pallas smoother in interpret mode
and the host polynomial smoother, on quad_mesh(12) as
tests/test_formats.py does (f32, rel <= 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.fem import assemble
from saamge_tpu.fem.mesh import quad_mesh
from saamge_tpu.ops.pallas_smoother import fused_dia_smoother as jax_fused
from saamge_tpu.ops.sparse import DeviceDIA
from saamge_tpu.solve import smoothers

from saamge_tpu_torch.ops.smoother import (fused_dia_smoother,
                                           inv_taus_f32, smoother_h)
from saamge_tpu_torch.ops.sparse import DIA

torch.set_num_threads(1)
F32 = torch.float32


@pytest.fixture(scope="module")
def quad():
    mesh = quad_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, _, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    pd = smoothers.init_poly_data(A, 2, "sas")
    return A, b, pd


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("x0", ["zero", "random"])
def test_fused_smoother_matches_jax_and_host(quad, x0):
    A, b, pd = quad
    x = (np.zeros(A.shape[0]) if x0 == "zero"
         else np.random.default_rng(0).standard_normal(A.shape[0]))
    dia = DIA.try_from_csr(A, F32)
    assert len(dia.offsets) == 9
    sm = fused_dia_smoother(dia, torch.as_tensor(pd.dinv, dtype=F32),
                            pd.roots)
    y = sm(torch.as_tensor(b, dtype=F32), torch.as_tensor(x, dtype=F32))
    y = y.numpy()
    jsm = jax_fused(DeviceDIA.try_from_csr(A, dtype=jnp.float32),
                    jnp.asarray(pd.dinv, dtype=jnp.float32), pd.roots,
                    interpret=True)
    y_jax = np.asarray(jsm(jnp.asarray(b, jnp.float32),
                           jnp.asarray(x, jnp.float32)))
    ref = smoothers.compute_poly(A, b, x.copy(), pd.roots, pd.dinv)
    assert _rel(y, y_jax) <= 1e-5
    assert _rel(y, ref) <= 1e-5


def test_smoother_emits_the_residual(quad):
    A, b, pd = quad
    dia = DIA.try_from_csr(A, F32)
    bh = dia.pad(torch.as_tensor(b))
    dinvh = dia.pad(torch.as_tensor(pd.dinv))
    xh, resh = smoother_h(dia, inv_taus_f32(pd.roots), bh, dinvh,
                          torch.zeros_like(bh), emit_residual=True)
    h = dia.halo
    assert torch.all(resh[:h] == 0) and torch.all(resh[-h:] == 0)
    x = dia.unpad(xh).double().numpy()
    assert _rel(dia.unpad(resh).numpy(), b - A @ x) <= 1e-5
    assert torch.equal(xh, smoother_h(dia, inv_taus_f32(pd.roots), bh,
                                      dinvh, torch.zeros_like(bh)))


def test_smoother_rejects_bad_calls(quad):
    A, b, pd = quad
    dia = DIA.try_from_csr(A, F32)
    bh = dia.pad(torch.as_tensor(b))
    with pytest.raises(ValueError, match="no roots"):
        smoother_h(dia, (), bh, bh, bh)
    with pytest.raises(ValueError, match="devices"):
        smoother_h(dia, (1.0,), bh.to("meta"), bh, bh)
