"""The port's compile_structured beyond the flagship configuration --
two and three levels, the coarsest inverse (``_device_spd_inverse``)
and ``convert.from_jax_arrays`` of the new hierarchies -- against the
JAX package's compile_structured (Pallas in interpret mode) on the
port's own host setup product: hex_mesh(8), 2^3 bricks, 2 or 3 levels
(the JAX tests' ``_setup(8, 2, num_levels)``).  The coarsest
restriction, mid format and mid route variants are in
test_torch_structured_variants.py, which shares ``_setup``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import (compile_hierarchy, compile_structured,
                              pcg_solve, struct_pcg_solve,
                              struct_vcycle_apply, vcycle_apply)
from saamge_tpu_torch.api import SpectralAMGSolver
from saamge_tpu_torch.config import SolverOptions
from saamge_tpu_torch.convert import from_jax_arrays
from saamge_tpu_torch.fem import assemble
from saamge_tpu_torch.fem.mesh import hex_mesh
from saamge_tpu_torch.solve import structured as TS
from saamge_tpu_torch.topology.part import (partition_cartesian_3d,
                                            partition_cartesian_bricks)

torch.set_num_threads(1)

TOLS = (1e-6, 1e-8)
F32 = torch.float32
BF16 = torch.bfloat16
ALL_F32 = dict(smoother_dtype=F32, rp_dtype=F32, mid_dtype=F32,
               device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(n=8, nb=2, num_levels=2, sb=None):
    """(ml, b, geo, supers) of the port's host setup: unit coefficient,
    or with superbricks ``sb`` coefficients 10^U(-1, 1) from seed 3 and
    the 3rd-level partitioning made of sb^3 superbricks."""
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = 1.0
    override = supers = None
    if sb is not None:
        rng = np.random.default_rng(3)
        coef = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
        supers = (sb,) * 3

        def override(i):
            assert i == 1
            return partition_cartesian_bricks((nb,) * 3, supers)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    opts = SolverOptions(num_levels=num_levels, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, coarse_part_override=override,
                          setup_device="cpu")
    geo = TS.BrickGeometry((nb,) * 3, (n // nb,) * 3)
    return s.ml, np.asarray(b, np.float64), geo, supers


def _jgeo(geo):
    return JS.BrickGeometry(geo.bricks, geo.brick_elems)


def _jax_solves(hj, b):
    bj = jnp.asarray(b, jnp.float32)
    y = np.asarray(JS.struct_vcycle_apply(hj, bj))
    out = [JS.struct_pcg_solve(hj, bj, rel_tol=t, max_iter=60) for t in TOLS]
    return y, [int(o[1]) for o in out], np.asarray(out[-1][0])


def _port_solves(h, b, vcycle=struct_vcycle_apply, pcg=struct_pcg_solve):
    bt = torch.as_tensor(b, dtype=F32)
    y = vcycle(h, bt).numpy()
    out = [pcg(h, bt, rel_tol=t, max_iter=60) for t in TOLS]
    return y, [int(o[1]) for o in out], out[-1][0].numpy()


def _close(y, y_ref, tol):
    err = np.abs(y - y_ref).max()
    assert err <= tol * np.abs(y_ref).max(), (err, np.abs(y_ref).max())


# -- (a) two and three levels against the JAX structured and the port's
#        generic hierarchy ---------------------------------------------------


@pytest.mark.parametrize("num_levels", [2, 3])
def test_struct_matches_generic_vcycle(num_levels):
    """The port's structured V-cycle (dense R1 at three levels: no
    superbrick grid) equals the JAX structured one and the port's generic
    compiled one up to the coarsest-solve form and f32 order."""
    ml, b, geo, _ = _setup(8, 2, num_levels)
    h = compile_structured(ml, geo, **ALL_F32)
    assert h.levels == num_levels
    if num_levels == 2:
        assert h.mid_route is None and h.dinv1 is None
        assert h.Ainv.shape == (ml.levels[0].tg_data.Ac.shape[0],) * 2
    else:
        assert h.R1 is not None and h.Rst1 is None
    y = struct_vcycle_apply(h, torch.as_tensor(b, dtype=F32)).numpy()
    y_jax = np.asarray(JS.struct_vcycle_apply(
        JS.compile_structured(ml, _jgeo(geo)), jnp.asarray(b, jnp.float32)))
    y_gen = vcycle_apply(compile_hierarchy(ml, F32, device="cpu"),
                         torch.as_tensor(b, dtype=F32)).numpy()
    _close(y, y_jax, 5e-4)
    _close(y, y_gen, 5e-4)


@pytest.mark.parametrize("num_levels", [2, 3])
def test_struct_pcg_iteration_parity(num_levels):
    ml, b, geo, _ = _setup(8, 2, num_levels)
    _, its, x = _port_solves(compile_structured(ml, geo, **ALL_F32), b)
    _, its_jax, x_jax = _jax_solves(
        JS.compile_structured(ml, _jgeo(geo)), b)

    def gen_pcg(h, b, rel_tol, max_iter):
        return pcg_solve(h, b, rel_tol=rel_tol, max_iter=max_iter)
    _, its_gen, x_gen = _port_solves(
        compile_hierarchy(ml, F32, device="cpu"), b, vcycle_apply, gen_pcg)
    assert its == its_jax == its_gen
    for ref in (x_jax, x_gen):
        assert np.allclose(x, ref, atol=1e-3 * np.abs(ref).max())


# -- (e) the coarsest inverse -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spd(n):
    """(Q diag(lam) Q^T, its f64 inverse Q diag(1/lam) Q^T, Q, lam):
    eigenvalues logspace(0, 2), condition number 1e2, from seed 5."""
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, 2, n)
    return (Q * lam) @ Q.T, (Q / lam) @ Q.T, Q, lam


@pytest.mark.parametrize("n", [300, 4160])
def test_device_spd_inverse_matches_jax(n):
    """n = 300: the host f64 inverse, bit-equal to the JAX one; n = 4160:
    the Cholesky branch with a partial last chunk (2 x 2048 + 64), each
    of the port's and the JAX inverse within 1e-4 x max |inverse| of the
    f64 inverse."""
    A, inv64, _, _ = _spd(n)
    got = TS._device_spd_inverse(A, "cpu")
    ref = np.asarray(JS._device_spd_inverse(A))
    assert got.dtype == F32 and got.shape == (n, n)
    if n <= TS.SPD_HOST_MAX:
        assert np.array_equal(got.numpy(), ref)
        return
    scale = np.abs(inv64).max()
    assert np.abs(got.numpy() - inv64).max() <= 1e-4 * scale
    assert np.abs(ref - inv64).max() <= 1e-4 * scale


def test_device_spd_inverse_raises_when_indefinite():
    """One negative eigenvalue: the f32 Cholesky fails, and the port
    raises with the pivot where the JAX cho_factor gives NaN."""
    _, _, Q, lam = _spd(4160)
    lam = lam.copy()
    lam[7] = -1.0
    with pytest.raises(np.linalg.LinAlgError, match="leading minor"):
        TS._device_spd_inverse((Q * lam) @ Q.T, "cpu")


# -- (f) from_jax_arrays ------------------------------------------------------


CONFIGS = {
    "two_level": (2, {}),
    "dense_R1": (3, {}),
    "dense_mid": (3, {"mid_format": "dense"}),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_from_jax_arrays_equals_compile(config):
    """The JAX hierarchy's arrays give the port's compile_structured
    hierarchy on the same setup, buffer for buffer."""
    num_levels, kw = CONFIGS[config]
    ml, _, geo, _ = _setup(8, 2, num_levels)
    hj = JS.compile_structured(ml, _jgeo(geo), **kw)
    d = {"A0.vals2": hj.A0.vals2, "dinv0h": hj.dinv0h,
         "taus0": np.concatenate([np.asarray(t) for t in hj.taus0]),
         "Rst": hj.Rst, "flat_id": hj.flat_id, "Ainv": hj.Ainv}
    meta = {"offsets": hj.A0.offsets, "n": hj.n_fine, "hr": hj.A0.hr,
            "bricks": geo.bricks, "brick_elems": geo.brick_elems}
    if hj.A1d is not None:
        d.update(dinv1=hj.dinv1, R1=hj.R1, taus1=np.concatenate(
            [np.asarray(t) for t in hj.taus1]))
        if isinstance(hj.A1d, JS.BrickBlockOp):
            d["A1d.blocks"] = hj.A1d.blocks
            meta.update(doffs=hj.A1d.doffs, rects=hj.A1d.rects)
        else:
            d["A1d"] = hj.A1d
    hc = from_jax_arrays({k: np.asarray(v) for k, v in d.items()}, meta)
    h = compile_structured(ml, geo, **kw, **ALL_F32)
    theirs = dict(hc.named_buffers())
    assert sorted(theirs) == sorted(name for name, _ in h.named_buffers())
    for name, buf in h.named_buffers():
        assert theirs[name].dtype == buf.dtype, name
        assert torch.equal(theirs[name], buf), name
    for attr in ("levels", "mid_route", "offsets", "n", "geo", "supers",
                 "taus0", "taus1", "doffs", "rects"):
        assert getattr(hc, attr) == getattr(h, attr), attr


# -- options that the two-level branch ignores --------------------------------


def test_two_level_ignores_mid_options():
    """The JAX two-level branch has no mid level or superbricks and
    stores its inverse in f32 whatever ``ainv_dtype`` says."""
    ml, _, geo, _ = _setup(8, 2, 2)
    h = compile_structured(ml, geo, **ALL_F32)
    h2 = compile_structured(ml, geo, ainv_dtype=BF16, mid_format="dense",
                            mid_resident=False, **ALL_F32)
    assert h2.Ainv.dtype == F32 and h2.levels == 2
    assert torch.equal(h.Ainv, h2.Ainv)


def test_compile_rejects_four_levels():
    ml, _, geo, _ = _setup(8, 2, 3)

    class Deeper:
        levels = ml.levels + ml.levels[-1:]
    with pytest.raises(ValueError, match="2- or 3-level"):
        compile_structured(Deeper(), geo, **ALL_F32)
