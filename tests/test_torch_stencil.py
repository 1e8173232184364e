"""Port stencil passes and smoother sweeps (saamge_tpu_torch/ops/stencil.py,
ops/wavefront.py) against the JAX Pallas kernels (PallasDIA,
wavefront_smooth; interpret mode on the CPU) on the flagship n=16 fine
operator, with the same numpy-seeded vectors.  On the CPU the port's
wrappers run their plain torch versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops.pallas_stencil import PallasDIA
from saamge_tpu.ops.pallas_wavefront import wavefront_smooth as jax_wavefront
from saamge_tpu.ops.sparse import DeviceDIA

from saamge_tpu_torch import flagship_problem
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.sparse import DIA, dia_spmv
from saamge_tpu_torch.ops.stencil import stencil_h
from saamge_tpu_torch.ops.wavefront import wavefront_smooth

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def fine():
    ml, _, _, _ = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    A = ml.levels[0].A
    pd = ml.levels[0].tg_data.poly_data
    rng = np.random.default_rng(11)
    n = A.shape[0]
    vecs = {k: rng.standard_normal(n).astype(np.float32)
            for k in ("x", "b")}
    vecs["dinv"] = np.asarray(pd.dinv, np.float32)
    taus = [float(np.float32(1.0 / float(t))) for t in np.asarray(pd.roots)]
    dia = DeviceDIA.try_from_csr(A, jnp.float32, max_diags=64)
    return A, dia, vecs, taus


def _ops(fine, dtype):
    A, dia, _, _ = fine
    tdt, jdt = DTYPES[dtype]
    pj = PallasDIA.from_dia(dia, interpret=True, dtype=jdt)
    pt = DIA.from_csr(A, torch.float32)
    pt = DIA(pt.vals.to(tdt), pt.offsets, pt.n)
    return pj, pt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_stencil_matches_pallas(fine, mode, dtype):
    _, _, v, taus = fine
    pj, pt = _ops(fine, dtype)
    jx, jb, jd = (pj.pad(jnp.asarray(v[k])) for k in ("x", "b", "dinv"))
    tx, tb, td = (pt.pad(torch.as_tensor(v[k])) for k in ("x", "b", "dinv"))
    if mode == "spmv":
        ref = pj.matvec_h(jx)
        got = stencil_h("spmv", pt, tx)
    elif mode == "residual":
        ref = pj.residual_h(jb, jx)
        got = stencil_h("residual", pt, tx, bh=tb)
    else:
        ref = pj.root_h(jnp.asarray([taus[0]], jnp.float32), jb, jd, jx)
        got = stencil_h("root", pt, tx, bh=tb, dinvh=td, inv_tau=taus[0])
    ref = np.asarray(pj.unpad(ref))
    # the haloed output keeps a zero halo (chainability)
    assert torch.all(got[:pt.halo] == 0) and torch.all(got[-pt.halo:] == 0)
    got = pt.unpad(got).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_dia_spmv_matches_csr(fine):
    A, _, v, _ = fine
    pt = DIA.from_csr(A, torch.float32)
    y = dia_spmv(pt, torch.as_tensor(v["x"])).numpy()
    ref = A @ v["x"].astype(np.float64)
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("emit_res", [False, True])
def test_wavefront_plain_matches_pallas(fine, emit_res):
    """k=10 chained roots of the bf16 smoother twin (+ the residual)."""
    _, _, v, taus = fine
    assert len(taus) == 10
    pj, pt = _ops(fine, "bf16")
    jx, jb, jd = (pj.pad(jnp.asarray(v[k])) for k in ("x", "b", "dinv"))
    tx, tb, td = (pt.pad(torch.as_tensor(v[k])) for k in ("x", "b", "dinv"))
    jt = tuple(jnp.asarray([t], jnp.float32) for t in taus)
    ref = jax_wavefront(pj, jt, jb, jd, jx, emit_residual=emit_res)
    got = wavefront_smooth(pt, taus, tb, td, tx, emit_residual=emit_res)
    if not emit_res:
        ref, got = (ref,), (got,)
    for r, g in zip(ref, got):
        r = np.asarray(pj.unpad(r))
        g = pt.unpad(g).numpy()
        assert np.abs(g - r).max() <= 5e-5 * np.abs(r).max()


def test_wrappers_raise_off_cpu_and_cuda(fine):
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers dispatch on the device and never fall back silently."""
    pt = DIA.from_csr(fine[0], torch.float32)
    xh = torch.empty(pt.n + 2 * pt.halo, device="meta")
    with pytest.raises(ValueError, match="devices"):
        stencil_h("spmv", pt, xh)
    with pytest.raises(ValueError, match="devices"):
        wavefront_smooth(pt, (1.0,), xh, xh, xh)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing toolchain is an error, never a silent plain path."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load()
