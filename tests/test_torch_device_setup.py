"""The port's device setup (saamge_tpu_torch/setup/device_setup.py and
ops/filtered_eig.py) against the JAX package's on the same problems, run
on the CPU (``device="cpu"``): the same uniform plan, the same per-AE
spectral cuts, the same hierarchy; and the port's filtered eigensolver
against eigh.  Mirrors tests/test_device_setup.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu import api as J_api
from saamge_tpu.config import SolverOptions as JOptions
from saamge_tpu.fem import assemble as J_assemble
from saamge_tpu.fem.mesh import hex_mesh as J_hex_mesh
from saamge_tpu.ops.filtered_eig import \
    batched_smallest_eigs as J_smallest_eigs
from saamge_tpu.setup import device_setup as J_ds
from saamge_tpu.setup.elmat import GeometricProvider as J_Provider
from saamge_tpu.topology import part as J_part

from saamge_tpu_torch import api as P_api
from saamge_tpu_torch import compile_structured, struct_pcg_solve
from saamge_tpu_torch.config import SolverOptions as POptions
from saamge_tpu_torch.fem import assemble as P_assemble
from saamge_tpu_torch.fem.mesh import hex_mesh as P_hex_mesh
from saamge_tpu_torch.ops import filtered_eig as P_fe
from saamge_tpu_torch.setup import device_setup as P_ds
from saamge_tpu_torch.setup.elmat import GeometricProvider as P_Provider
from saamge_tpu_torch.topology import part as P_part
from saamge_tpu_torch.utils.logging import TIMERS

torch.set_num_threads(1)

PKG = {"jax": (J_api, J_assemble, J_hex_mesh, J_part, J_Provider),
       "port": (P_api, P_assemble, P_hex_mesh, P_part, P_Provider)}


def _problem(side, n, nb, coef="random", kway=False):
    """hex_mesh(n), nb^3 Cartesian bricks (or a k-way partition into nb^3
    parts), per-element coefficients 10^U(-2, 2) from seed 0; built by
    the package of ``side``.  Returns (provider, rels, em)."""
    api, assemble, hex_mesh, part, Provider = PKG[side]
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    if coef == "random":
        coef = 10.0 ** np.random.default_rng(0).uniform(
            -2, 2, mesh.num_elements)
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    if kway:
        p = np.asarray(part.partition_kway(mesh.elem_to_elem(), None,
                                           nb ** 3))
    else:
        p = part.partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    rels = api.geometric_partitioning(A, mesh, api.bdr_dof_flags(mesh, ess),
                                      nb ** 3, partitioning=p)
    return Provider(rels, A, em), rels, em


def test_analyze_uniform_same_plan():
    _, rj, emj = _problem("jax", 8, 2)
    _, rp, emp = _problem("port", 8, 2)
    pj, pp = J_ds.analyze_uniform(rj, emj), P_ds.analyze_uniform(rp, emp)
    assert pj is not None and pp is not None
    assert (pp.n, pp.e_loc, pp.r) == (pj.n, pj.e_loc, pj.r) == (125, 64, 1)
    np.testing.assert_array_equal(pp.loc, pj.loc)
    np.testing.assert_array_equal(pp.elems, pj.elems)
    np.testing.assert_array_equal(pp.essmask, pj.essmask)
    np.testing.assert_allclose(pp.coef, pj.coef, rtol=1e-12, atol=0)
    # a k-way partition has AEs of unequal sizes: no plan on either side
    _, rj2, emj2 = _problem("jax", 8, 2, kway=True)
    _, rp2, emp2 = _problem("port", 8, 2, kway=True)
    assert J_ds.analyze_uniform(rj2, emj2) is None
    assert P_ds.analyze_uniform(rp2, emp2) is None


def _b_projector(X, B):
    return X @ X.T * B[None, :]


def _assert_cuts_match(out_p, out_j, routes, route):
    cut, skipped, bdiags, aes = out_p
    cut_j, skipped_j, bdiags_j, aes_j = out_j
    assert routes.get(route) == len(cut) and routes["host_resolve"] == 0
    for p in range(len(cut)):
        # per AE: the same cut count, bdiags, skipped and B-projector
        assert cut[p].shape == cut_j[p].shape, f"AE {p}"
        np.testing.assert_allclose(bdiags[p], bdiags_j[p], rtol=1e-4)
        assert abs(skipped[p] - skipped_j[p]) \
            <= 1e-4 * max(abs(skipped_j[p]), 1e-30)
        Pj = _b_projector(cut_j[p], bdiags_j[p])
        Pp = _b_projector(cut[p], bdiags[p])
        assert np.linalg.norm(Pp - Pj) <= 5e-3 * np.linalg.norm(Pj), p
        # the sparse AE export: the same f64 values
        d = abs(aes[p] - aes_j[p])
        assert (d.max() if d.nnz else 0.0) \
            <= 1e-12 * abs(aes_j[p]).max(), p


@pytest.mark.parametrize("n,route", [(8, "eigh"), (16, "filter")])
def test_uniform_cut_matches_jax(n, route):
    """hex_mesh(8) with 2^3 bricks has 125-dof AEs (exact eigh);
    hex_mesh(16) with 2^3 bricks of 8^3 elements has 729-dof AEs, which
    take the Chebyshev filter (FILTERED_EIG_MIN_N = 192)."""
    theta = 0.003
    prov_j, _, _ = _problem("jax", n, 2)
    prov_p, _, _ = _problem("port", n, 2)
    out_j = J_ds.uniform_spectral_cut(prov_j, theta)
    routes = {}
    out_p = P_ds.uniform_spectral_cut(prov_p, theta, device="cpu",
                                      routes=routes)
    assert out_j is not None and out_p is not None
    _assert_cuts_match(out_p, out_j, routes, route)


def _aniso(side):
    api, assemble, hex_mesh, part, Provider = PKG[side]
    from importlib import import_module
    coefficients = import_module(
        "saamge_tpu.fem.coefficients" if side == "jax"
        else "saamge_tpu_torch.fem.coefficients")
    mesh = hex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = coefficients.anisotropic_tensor(lambda x: np.array(
        [1.0, 0.5 * np.sin(4 * x[0]), 0.25]), eps=0.01)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess, matrix_coef=True)
    p = part.partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    return mesh, ess, A, b, em, p


def _iters_dims(api, Options, mesh, ess, A, b, em, p, device_setup,
                **kw):
    opts = Options(num_levels=2, correct_nulspace=False,
                   device_setup=device_setup)
    s = api.SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                              partitioning=p.copy(), **kw)
    return s.solve(b).iterations, s.ml.levels[0].tg_data.Ac.shape[0]


def test_device_setup_covers_anisotropic_tensor():
    """The anisotropic tensor coefficient (r > 1 element basis) takes the
    device pipeline on both sides with the same plan rank and cuts, and
    the hierarchy matches the host setup."""
    mj, essj, Aj, bj, emj, pj = _aniso("jax")
    mp, essp, Ap, bp, emp, pp = _aniso("port")
    api = P_api
    rels = api.geometric_partitioning(Ap, mp, api.bdr_dof_flags(mp, essp),
                                      8, partitioning=pp)
    plan = P_ds.analyze_uniform(rels, emp)
    relsj = J_api.geometric_partitioning(
        Aj, mj, J_api.bdr_dof_flags(mj, essj), 8, partitioning=pj)
    assert plan is not None and 1 < plan.r <= 8
    assert plan.r == J_ds.analyze_uniform(relsj, emj).r
    routes = {}
    out_p = P_ds.uniform_spectral_cut(P_Provider(rels, Ap, emp), 0.003,
                                      device="cpu", routes=routes)
    out_j = J_ds.uniform_spectral_cut(J_Provider(relsj, Aj, emj), 0.003)
    _assert_cuts_match(out_p, out_j, routes, "eigh")
    it_h, d_h = _iters_dims(P_api, POptions, mp, essp, Ap, bp, emp, pp,
                            False)
    it_d, d_d = _iters_dims(P_api, POptions, mp, essp, Ap, bp, emp, pp,
                            True, setup_device="cpu")
    it_j, d_j = _iters_dims(J_api, JOptions, mj, essj, Aj, bj, emj, pj,
                            True)
    assert d_h == d_d == d_j
    assert abs(it_d - it_h) <= 1 and abs(it_d - it_j) <= 1


def test_full_solver_device_setup_parity():
    """End to end on hex_mesh(8), constant coefficient, 2^3 bricks: the
    port's device setup (on the CPU) against the JAX device setup and the
    port's host setup: equal coarse dims, host-PCG iterations within 1."""
    out = {}
    for side, api, assemble, hex_mesh, part, Options in (
            ("jax", J_api, J_assemble, J_hex_mesh, J_part, JOptions),
            ("port", P_api, P_assemble, P_hex_mesh, P_part, POptions)):
        mesh = hex_mesh(8)
        ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        A, b, em, _, _ = assemble.build_discrete_problem(
            mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
        p = part.partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
        kw = {"setup_device": "cpu"} if side == "port" else {}
        out[side] = _iters_dims(api, Options, mesh, ess, A, b, em, p, True,
                                **kw)
        if side == "port":
            out["host"] = _iters_dims(api, Options, mesh, ess, A, b, em, p,
                                      False)
    assert out["port"][1] == out["jax"][1] == out["host"][1]
    assert abs(out["port"][0] - out["jax"][0]) <= 1
    assert abs(out["port"][0] - out["host"][0]) <= 1


def test_flagship_device_setup_n16():
    """flagship n=16, bricks of 8 (729-dof AEs: the filter), superbricks
    (2,2,2): the device setup gives the host setup's coarse dims, and its
    structured PCG (CPU plain versions) takes the host-setup flagship's
    iterations within 1."""
    runs = {}
    for dev in (False, True):
        ml, b, geo, supers = P_api.flagship_problem(
            n=16, brick=8, supers=(2, 2, 2), device_setup=dev, device="cpu")
        dims = [lv.tg_data.Ac.shape[0] for lv in ml.levels]
        h = compile_structured(ml, geo, supers, device="cpu")
        bt = torch.as_tensor(b, dtype=torch.float32)
        its = [struct_pcg_solve(h, bt, rel_tol=t, max_iter=60)[1]
               for t in (1e-6, 1e-8)]
        runs[dev] = (dims, its, ml.levels[0].tg_data.interp_data.eig_routes)
    assert runs[True][0] == runs[False][0]
    for a, c in zip(runs[True][1], runs[False][1]):
        assert abs(a - c) <= 1
    assert runs[True][2]["filter"] == 8


def _cluster_stack(B, n, rng):
    mats = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        # spectrum with a low cluster (spectral-AMGe-like)
        w = np.concatenate([rng.uniform(1e-4, 0.05, 12),
                            rng.uniform(0.3, 2.0, n - 12)])
        mats.append((Q * w) @ Q.T)
    return mats


def test_filtered_eig_matches_eigh_and_jax():
    """The 12 lowest pairs of a clustered SPD stack, at the JAX test's
    tolerances; the port's eigenvalues agree with the JAX solver's."""
    mats = _cluster_stack(6, 256, np.random.default_rng(3))
    m = 24
    stack = np.stack(mats).astype(np.float32)
    w_got, X, res = P_fe.batched_smallest_eigs(torch.as_tensor(stack), m)
    w_j, _, res_j = J_smallest_eigs(jnp.asarray(stack), m)
    X = X.double().numpy()
    for b in range(len(mats)):
        w_ref = np.linalg.eigvalsh(mats[b])[:m]
        assert np.allclose(w_got[b][:12], w_ref[:12], rtol=5e-3, atol=5e-5)
        assert np.allclose(w_got[b][:12], w_j[b][:12], rtol=5e-3, atol=5e-5)
        assert res[b][:12].max() < 0.05 and res_j[b][:12].max() < 0.05
        for j in range(12):
            x = X[b][:, j]
            lam = x @ (mats[b] @ x) / (x @ x)
            r = mats[b] @ x - lam * x
            assert np.linalg.norm(r) <= 5e-3 * np.linalg.norm(
                mats[b] @ x) + 1e-4, (b, j)


def test_filtered_eig_residual_guard_flags_hard_spectrum():
    """A degree-1 single-round filter on a gapless spectrum reports its
    failure through the residual channel on both sides; the production
    settings on an easy spectrum stay below the guard."""
    rng = np.random.default_rng(11)
    n, m = 256, 24
    P = rng.standard_normal((n, n)) * 0.002
    P = (P + P.T) / 2
    A = (np.diag(np.linspace(1.0, 2.0, n)) + P)[None].astype(np.float32)
    _, _, res = P_fe.batched_smallest_eigs(torch.as_tensor(A), m,
                                           degree=1, rounds=1)
    _, _, res_j = J_smallest_eigs(jnp.asarray(A), m, degree=1, rounds=1)
    assert res[0].max() > 0.05 and res_j[0].max() > 0.05
    w2 = np.concatenate([np.full(8, 1e-3), np.linspace(0.9, 1.1, n - 8)])
    A2 = (np.diag(w2) + P)[None].astype(np.float32)
    _, _, res2 = P_fe.batched_smallest_eigs(torch.as_tensor(A2), m)
    assert res2[0][:8].max() < 0.05


def test_orthonormalize_flags_failed_cholesky():
    """An all-zero block has a zero Gram matrix and a zero ridge: the
    port's Cholesky-QR flags it and passes it through (JAX's returns
    NaN), and the others are orthonormalized as usual."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.standard_normal((3, 40, 6)), dtype=torch.float32)
    X[1] = 0.0
    Q, bad = P_fe._orthonormalize(X)
    assert bad.tolist() == [False, True, False]
    assert torch.isfinite(Q).all() and (Q[1] == 0).all()
    for k in (0, 2):
        torch.testing.assert_close(Q[k].T @ Q[k], torch.eye(6),
                                   atol=1e-4, rtol=0)
    # a zero matrix in a batch: +inf eigenvalues and residuals for it, the
    # others solved as alone
    mats = _cluster_stack(2, 64, rng)
    M = torch.as_tensor(np.stack([mats[0], np.zeros((64, 64)), mats[1]]),
                        dtype=torch.float32)
    w, Xr, res = P_fe.batched_smallest_eigs(M, 16)
    assert np.isinf(w[1]).all() and np.isinf(res[1]).all()
    assert np.isfinite(w[[0, 2]]).all() and res[[0, 2], :8].max() < 0.05
    for k, mk in ((0, mats[0]), (2, mats[1])):
        np.testing.assert_allclose(w[k][:8], np.linalg.eigvalsh(mk)[:8],
                                   rtol=5e-3, atol=5e-5)


def test_start_block_chunks_concatenate():
    """The filter's start rows drawn chunk after chunk from one generator
    are the rows of one whole-batch draw (batched_eig's chunking)."""
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((c, 5, 3)) for c in (3, 4, 1)]
    whole = np.random.default_rng(0).standard_normal((8, 5, 3))
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_device_setup_without_card_raises():
    """device_setup=True with setup_device="cuda" and no card raises
    before any local eigensolve; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mesh = P_hex_mesh(4)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = P_assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    p = P_part.partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    before = {k: TIMERS.counts.get(k, 0) for k in
              ("setup.device_pipeline", "setup.local_eigensolves")}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _iters_dims(P_api, POptions, mesh, ess, A, b, em, p, True,
                    setup_device="cuda")
    assert before == {k: TIMERS.counts.get(k, 0) for k in before}
    with pytest.raises(ValueError, match="times the card"):
        P_fe.measure_eig_throughput(2, 16, 4, device="cpu")
