"""The port's general solve path (solve/compiled.py: compile_hierarchy,
vcycle, pcg_solve, compile_two_level; convert.from_jax_compiled)
against the JAX package's solve/compiled.py on the same host setup
product, and against the host V-cycle: f64 to rtol 1e-9 with equal PCG
iterations; f32 against both JAX smoothing branches (the fused Pallas
smoother in interpret mode and the blocked stencil passes) to 1e-5
with PCG iterations within 1."""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import saamge_tpu.ops.pallas_smoother as jax_psm  # noqa: E402
from saamge_tpu.solve import compiled as JC  # noqa: E402
from saamge_tpu.solve.vcycle import tg_cycle  # noqa: E402

from saamge_tpu_torch.api import (SpectralAMGSolver,  # noqa: E402
                                  checkerboard_coef, entry, general_problem)
from saamge_tpu_torch.config import SolverOptions  # noqa: E402
from saamge_tpu_torch.convert import from_jax_compiled  # noqa: E402
from saamge_tpu_torch.fem import assemble  # noqa: E402
from saamge_tpu_torch.fem.mesh import hex_mesh, quad_mesh  # noqa: E402
from saamge_tpu_torch.ops.blockrow import BlockRow  # noqa: E402
from saamge_tpu_torch.ops.sparse import DIA, ELL  # noqa: E402
from saamge_tpu_torch.solve import compiled as C  # noqa: E402

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64


def _solver(mesh, coef, **opts):
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    s = SpectralAMGSolver(A, mesh, em,
                          SolverOptions(correct_nulspace=False, **opts),
                          ess_attr_marker=ess)
    return A, b, s


@pytest.fixture(scope="module")
def three_level():
    """The quad_mesh(20) 3-level fixture of tests/test_compiled.py."""
    return _solver(quad_mesh(20), checkerboard_coef, num_levels=3,
                   first_elems_per_agg=16, elems_per_agg=4)


@pytest.fixture(scope="module")
def hex6():
    """The hex_mesh(6) 2-level setup of tests/test_pallas_stencil.py."""
    return _solver(hex_mesh(6), 1.0, num_levels=2, first_elems_per_agg=32,
                   elems_per_agg=32)


def _host_cycle(A, tg, r):
    z = np.zeros_like(r)
    tg_cycle(A, tg, r, z)
    return z


def _r(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() \
        / np.abs(np.asarray(ref)).max()


def test_vcycle_f64_matches_jax_and_host(three_level):
    A, _, s = three_level
    h = C.compile_hierarchy(s.ml, F64, device="cpu")
    assert isinstance(h.levels[0].A, DIA)
    assert isinstance(h.levels[1].A, BlockRow)
    assert isinstance(h.levels[0].R, BlockRow)
    assert not any(lv.fused for lv in h.levels)
    r = _r(A.shape[0])
    z = C.vcycle_apply(h, torch.as_tensor(r)).numpy()
    hj = JC.compile_hierarchy(s.ml, dtype=jnp.float64)
    np.testing.assert_allclose(z, np.asarray(JC.vcycle_apply(
        hj, jnp.asarray(r))), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(z, _host_cycle(A, s.ml.finest.tg_data, r),
                               rtol=1e-9, atol=1e-9)


def test_pcg_f64_iterations_match(three_level):
    A, b, s = three_level
    h = C.compile_hierarchy(s.ml, F64, device="cpu")
    hj = JC.compile_hierarchy(s.ml, dtype=jnp.float64)
    its = []
    for tol in (1e-6, 1e-8):
        x, it, _ = C.pcg_solve(h, torch.as_tensor(b), rel_tol=tol)
        xj, itj, _ = JC.pcg_solve(hj, jnp.asarray(b), rel_tol=tol)
        assert it == int(itj)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8,
                                   atol=1e-10)
        its.append(it)
    assert its[0] == s.solve(b).iterations      # the host PCG, at 1e-6
    # a warm start from the solution stops at once
    _, it0, _ = C.pcg_solve(h, torch.as_tensor(b), x0=x, rel_tol=1e-6,
                            abs_tol=1e-10)
    assert it0 <= 1


def test_wcycle_f64_matches_jax(three_level):
    A, _, s = three_level
    h = C.compile_hierarchy(s.ml, F64, device="cpu")
    hj = JC.compile_hierarchy(s.ml, dtype=jnp.float64)
    r = _r(A.shape[0], 4)
    x = _r(A.shape[0], 5)
    z = C.vcycle(h, torch.as_tensor(r), torch.as_tensor(x), mu=2).numpy()
    zj = JC.vcycle(hj, jnp.asarray(r), jnp.asarray(x), mu=2)
    np.testing.assert_allclose(z, np.asarray(zj), rtol=1e-9, atol=1e-9)


def test_smoothed_P_ell_matches_jax_and_host():
    """Smoothed prolongator (nu_pro = 2): ELL-format P/R."""
    A, _, s = _solver(quad_mesh(20), checkerboard_coef, num_levels=2,
                      first_elems_per_agg=16, nu_pro=2, first_nu_pro=2)
    assert s.ml.finest.tg_data.smooth_interp
    h = C.compile_hierarchy(s.ml, F64, device="cpu")
    assert isinstance(h.levels[0].P, ELL)
    r = _r(A.shape[0], 4)
    z = C.vcycle_apply(h, torch.as_tensor(r)).numpy()
    hj = JC.compile_hierarchy(s.ml, dtype=jnp.float64)
    np.testing.assert_allclose(z, np.asarray(JC.vcycle_apply(
        hj, jnp.asarray(r))), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(z, _host_cycle(A, s.ml.finest.tg_data, r),
                               rtol=1e-9, atol=1e-9)


def test_compile_two_level_matches_jax(three_level):
    A, _, s = three_level
    tg = s.ml.finest.tg_data
    h = C.compile_two_level(A, tg, F64, device="cpu")
    hj = JC.compile_two_level(A, tg, dtype=jnp.float64)
    r = _r(A.shape[0], 6)
    np.testing.assert_allclose(
        C.vcycle_apply(h, torch.as_tensor(r)).numpy(),
        np.asarray(JC.vcycle_apply(hj, jnp.asarray(r))), rtol=1e-9,
        atol=1e-9)


@pytest.mark.parametrize("branch", ["fused", "blocked"])
def test_f32_matches_both_jax_branches(hex6, branch, monkeypatch):
    """The port's one f32 DIA branch (fused smoother kernel, its plain
    version here) against the JAX fused Pallas smoother and, with the
    VMEM gate forced shut, the JAX blocked stencil passes."""
    A, b, s = hex6
    if branch == "blocked":
        monkeypatch.setattr(jax_psm, "fits_vmem", lambda *a, **k: False)
    hj = JC.compile_hierarchy(s.ml)
    assert (hj.levels[0].fused_smooth is not None) == (branch == "fused")
    h = C.compile_hierarchy(s.ml, F32, device="cpu")
    assert h.levels[0].fused and len(h.levels[0].offsets) == 27
    r = _r(A.shape[0]).astype(np.float32)
    z = C.vcycle_apply(h, torch.as_tensor(r)).numpy()
    assert _rel(z, JC.vcycle_apply(hj, jnp.asarray(r))) <= 1e-5
    x, it, _ = C.pcg_solve(h, torch.as_tensor(b, dtype=F32), max_iter=60)
    xj, itj, _ = JC.pcg_solve(hj, jnp.asarray(b, jnp.float32), max_iter=60)
    assert abs(it - int(itj)) <= 1
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-3


def test_from_jax_compiled_round_trip(three_level, hex6, monkeypatch):
    """DIA + block-row (f64) and blocked PallasDIA + ELL (f32) JAX
    hierarchies carried across give the same V-cycle as the port's own
    compile."""
    A, _, s = three_level
    hj = JC.compile_hierarchy(s.ml, dtype=jnp.float64)
    hc = from_jax_compiled(hj)
    h = C.compile_hierarchy(s.ml, F64, device="cpu")
    for name, buf in h.named_buffers():
        assert torch.equal(dict(hc.named_buffers())[name], buf), name
    r = torch.as_tensor(_r(A.shape[0]))
    assert torch.equal(C.vcycle_apply(hc, r), C.vcycle_apply(h, r))

    A6, _, s6 = hex6
    monkeypatch.setattr(jax_psm, "fits_vmem", lambda *a, **k: False)
    hj6 = JC.compile_hierarchy(s6.ml, use_block_row=False)
    assert type(hj6.levels[0].A).__name__ == "PallasDIA"
    hc6 = from_jax_compiled(hj6)
    assert isinstance(hc6.levels[0].P, ELL) and hc6.levels[0].fused
    r6 = _r(A6.shape[0]).astype(np.float32)
    z = C.vcycle_apply(hc6, torch.as_tensor(r6)).numpy()
    assert _rel(z, JC.vcycle_apply(hj6, jnp.asarray(r6))) <= 1e-5


def test_general_problem_pcg_f32_matches_jax():
    """The hexkway build (k-way agglomeration, 3 levels) at n=10."""
    ml, A, b = general_problem(n=10, elems_per_agg=64)
    h = C.compile_hierarchy(ml, F32, device="cpu")
    hj = JC.compile_hierarchy(ml)
    bt = torch.as_tensor(b, dtype=F32)
    for tol in (1e-6, 1e-8):
        x, it, _ = C.pcg_solve(h, bt, rel_tol=tol)
        itj = int(JC.pcg_solve(hj, jnp.asarray(b, jnp.float32),
                               rel_tol=tol)[1])
        assert abs(it - itj) <= 1
    res = np.linalg.norm(b - A @ x.double().numpy()) / np.linalg.norm(b)
    assert res <= 1e-5


def test_entry_runs_one_vcycle_on_cpu():
    fn, (h, b) = entry(device="cpu")
    assert isinstance(h, C.CompiledHierarchy) and h.levels[0].fused
    y = fn(h, b)
    assert y.shape == b.shape and bool(torch.isfinite(y).all())
    assert float(torch.dot(y, b)) > 0            # an SPD preconditioner
