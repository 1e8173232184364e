"""The port's batched eigensolver (saamge_tpu_torch/ops/batched_eig.py)
against the JAX package's (saamge_tpu/ops/batched_eig.py) and the host
Eigensolver, run on the CPU (``device="cpu"``).  Mirrors
tests/test_batched_eig.py.  The JAX test's matrices (5-100 dofs) fall
under the small-bucket rule and go to the host on both sides, so the
per-bucket device solve (``bucket_spectral_cut``) is also held to the
host Eigensolver directly, on a bucket of about 300-dof matrices: the
filter in f32, ``eigh`` in f64.  Both sides get ``dtype`` explicitly:
the JAX default depends on whether x64 is on, and with it on it never
takes the filter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops import batched_eig as J_be

from saamge_tpu_torch.ops import batched_eig as P_be
from saamge_tpu_torch.setup.spectral import Eigensolver, weighted_l1_diag

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64)}


def _rand_spd_laplacian(n, rng):
    """1D Laplacian-like SPD matrix with random weights."""
    w = rng.uniform(0.5, 2.0, n - 1)
    A = np.zeros((n, n))
    i = np.arange(n - 1)
    np.add.at(A, (i, i), w)
    np.add.at(A, (i + 1, i + 1), w)
    A[i, i + 1] -= w
    A[i + 1, i] -= w
    A += np.eye(n) * 1e-8
    return A


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(7)
    return [_rand_spd_laplacian(n, rng)
            for n in [5, 17, 17, 33, 64, 40, 8, 100]]


def test_batched_weighted_l1_matches(mats):
    stack = np.stack([m for m in mats if m.shape[0] == 17])
    got = P_be.batched_weighted_l1(stack)
    np.testing.assert_allclose(got, J_be.batched_weighted_l1(stack),
                               rtol=1e-12)
    for k, m in enumerate([m for m in mats if m.shape[0] == 17]):
        np.testing.assert_allclose(got[k], weighted_l1_diag(m), rtol=1e-12)


def _assert_like_host(cut, skipped, bdiags, mats, theta, proj_atol,
                      proj_rtol=0.0):
    eig = Eigensolver(use_truncated=False)
    for i, A in enumerate(mats):
        ev_h, skip_h, B_h = eig.solve(A, theta)
        assert cut[i].shape == ev_h.shape, f"AE {i}"
        np.testing.assert_allclose(bdiags[i], B_h, rtol=1e-10)
        np.testing.assert_allclose(skipped[i], skip_h, rtol=1e-6, atol=1e-9)
        # same invariant subspace: B-orthogonal projector difference small
        Pb_h = ev_h @ ev_h.T * B_h[None, :]
        Pb_d = cut[i] @ cut[i].T * bdiags[i][None, :]
        assert np.abs(Pb_d - Pb_h).max() \
            <= proj_atol + proj_rtol * np.abs(Pb_h).max(), i


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_batched_cut_matches_jax_and_host(mats, dt):
    theta = 0.05
    tdt, jdt = DTYPES[dt]
    routes = {}
    cut, skipped, bdiags = P_be.batched_spectral_cut(
        mats, theta, dtype=tdt, device="cpu", routes=routes)
    assert routes == {"host": len(mats)}
    cut_j, skipped_j, bdiags_j = J_be.batched_spectral_cut(mats, theta,
                                                           dtype=jdt)
    for i in range(len(mats)):
        assert cut[i].shape == cut_j[i].shape
        np.testing.assert_allclose(bdiags[i], bdiags_j[i], rtol=1e-12)
        np.testing.assert_allclose(skipped[i], skipped_j[i], rtol=1e-12)
        np.testing.assert_allclose(cut[i] @ cut[i].T,
                                   cut_j[i] @ cut_j[i].T, atol=1e-10)
    _assert_like_host(cut, skipped, bdiags, mats, theta, 1e-6)


def test_batched_cut_b_orthonormal(mats):
    cut, _, bdiags = P_be.batched_spectral_cut(mats, 0.05, device="cpu")
    for X, B in zip(cut, bdiags):
        G = X.T @ (B[:, None] * X)
        np.testing.assert_allclose(G, np.eye(X.shape[1]), atol=1e-6)


def test_truncated_mode_caps(mats):
    big = [m for m in mats if m.shape[0] > 64]
    cut, _, _ = P_be.batched_spectral_cut(big, 0.9, use_truncated=True,
                                          max_vectors=4, device="cpu")
    cut_j, _, _ = J_be.batched_spectral_cut(big, 0.9, use_truncated=True,
                                            max_vectors=4)
    for X, Xj in zip(cut, cut_j):
        assert X.shape[1] <= 4 and X.shape == Xj.shape


def _gap_mats(sizes=(290, 300, 310, 320)):
    """SPD matrices of the given sizes, 64 eigenvalues in [1e-4, 1e-2]
    and the rest in [0.5, 1]: the filter's 64 pairs converge."""
    rng = np.random.default_rng(1)
    mats = []
    for n in sizes:
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.geomspace(1e-4, 1e-2, 64),
                            rng.uniform(0.5, 1.0, n - 64)])
        mats.append((Q * w) @ Q.T)
    return mats


def _ae_mats():
    """The eight AE matrices (298-402 dofs) of a k-way partition of
    hex_mesh(12) with coefficients 10^U(-2, 2): the filter misses pairs
    of their spectra, and its residual guard sends each to the exact
    host solve (as the JAX function does)."""
    from saamge_tpu_torch import api
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    from saamge_tpu_torch.setup.elmat import GeometricProvider
    from saamge_tpu_torch.topology import part
    mesh = hex_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = 10.0 ** np.random.default_rng(7).uniform(-2, 2,
                                                     mesh.num_elements)
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    p = np.asarray(part.partition_kway(mesh.elem_to_elem(), None, 8))
    rels = api.geometric_partitioning(A, mesh, api.bdr_dof_flags(mesh, ess),
                                      8, partitioning=p)
    return GeometricProvider(rels, A, em).build_all_AE_stiff()


@pytest.mark.parametrize("case,dt,routed", [
    ("gap", "f32", {"filter": 4, "host_resolve": 0}),
    ("gap", "f64", {"eigh": 4}),
    ("ae", "f32", {"filter": 8, "host_resolve": 8})])
def test_bucket_device_solve_matches_host(case, dt, routed):
    """The per-bucket device solve, called on a small bucket of the 512
    size class (which batched_spectral_cut itself sends to the host),
    against the host Eigensolver: the same cut counts, bdiags and
    skipped values, and B-projectors within 5e-3 of the host's largest
    entry (f32 filter) or 1e-6 (f64 eigh, exact host re-solves).  Chunks
    of two: the filter's start rows are drawn chunk after chunk from one
    generator."""
    mats, theta = (_gap_mats(), 2e-4) if case == "gap" \
        else (_ae_mats(), 0.03)
    routes = {}
    out = P_be.bucket_spectral_cut(mats, 512, theta, dtype=DTYPES[dt][0],
                                   device="cpu", chunk=2, routes=routes)
    assert routes == routed
    if case == "gap" and dt == "f32":
        _assert_like_host(*out, mats, theta, 0.0, 5e-3)
    else:
        _assert_like_host(*out, mats, theta, 1e-6)
    assert max(c.shape[1] for c in out[0]) > 1


@pytest.mark.parametrize("case,dt", [("gap", "f64"), ("ae", "f32")])
def test_bucket_routes_counted_by_timers(case, dt):
    """The per-bucket device solve adds each route's count to the
    counter ``setup.eig_route.<route>`` of utils/logging.TIMERS, exactly
    as to the ``routes`` dict (the ``ae`` bucket re-solves all 8 on the
    host); no other route counter moves."""
    from saamge_tpu_torch.utils.logging import TIMERS
    mats, theta = (_gap_mats(), 2e-4) if case == "gap" \
        else (_ae_mats(), 0.03)
    key = "setup.eig_route."
    before = {k: v for k, v in TIMERS.counters.items() if k.startswith(key)}
    routes = {}
    P_be.bucket_spectral_cut(mats, 512, theta, dtype=DTYPES[dt][0],
                             device="cpu", chunk=2, routes=routes)
    grown = {k[len(key):]: v - before.get(k, 0)
             for k, v in TIMERS.counters.items() if k.startswith(key)}
    assert {k: v for k, v in grown.items() if v or k in routes} == routes
    assert routes.get("host_resolve", 0) == (8 if case == "ae" else 0)


def test_batched_cut_routes(monkeypatch):
    """The JAX routing: sparse AEs and AEs above device_max_n go to the
    host, and so does a bucket with len * nmax^3 < 2e10 (18 AEs of the
    1024 bucket); 19 of them go to the device (the device solve is
    replaced by a recorder here)."""
    import scipy.sparse as sp
    routes = {}
    mats = _gap_mats()
    mats[0] = sp.csr_matrix(mats[0])
    P_be.batched_spectral_cut(mats, 2e-3, device="cpu", routes=routes,
                              device_max_n=256)
    assert routes == {"host": 4}
    calls = []

    def record(mats, nmax, *args, **kwargs):
        calls.append((len(mats), nmax))
        return ([np.zeros((m.shape[0], 1)) for m in mats],
                [0.0] * len(mats), [np.ones(m.shape[0]) for m in mats])

    monkeypatch.setattr(P_be, "bucket_spectral_cut", record)
    big = _gap_mats((600,)) * 19
    for k, want in ((18, {"host": 18}), (19, {})):
        routes = {}
        P_be.batched_spectral_cut(big[:k], 1e-5, device="cpu",
                                  routes=routes)
        assert routes == want
    assert calls == [(19, 1024)]


def test_end_to_end_same_iterations():
    """Full solver with device_setup=True (setup_device="cpu") converges
    like the host path."""
    from saamge_tpu_torch.api import SpectralAMGSolver, checkerboard_coef
    from saamge_tpu_torch.config import SolverOptions
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import quad_mesh

    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, ess_attr_marker=ess)
    iters = {}
    for device_setup in (False, True):
        opts = SolverOptions(num_levels=2, correct_nulspace=False,
                             first_elems_per_agg=32,
                             device_setup=device_setup)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                              setup_device="cpu")
        res = s.solve(b)
        assert res.converged
        iters[device_setup] = res.iterations
    assert abs(iters[True] - iters[False]) <= 1, iters
