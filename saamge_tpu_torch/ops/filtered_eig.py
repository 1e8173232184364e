"""Chebyshev-filtered batched subspace eigensolver (batched f32 matmuls).

The port of saamge_tpu/ops/filtered_eig.py.  The setup pipeline needs
only the ~10-50 SMALLEST eigenpairs of each (scaled) AE operator, so
the batched solver is filtered subspace iteration built from batched
products:

  1. Gershgorin upper bound sigma per matrix (one |M| row sum);
  2. rounds of a degree-d Chebyshev filter p(M) X via the three-term
     recurrence -- p amplifies [0, a] against [a, sigma] exponentially in
     d -- followed by Cholesky-QR re-orthonormalization (Gram product +
     batched triangular solve);
  3. the filter cutoff a is set adaptively from a Rayleigh-Ritz estimate
     of the m-th eigenvalue after the first round (host f64 eigvalsh);
  4. one final m x m generalized Rayleigh-Ritz on the host in f64.

This replaces the reference's per-AE LAPACK dsygv / ARPACK dispatch
(xpacks.cpp:224-315, arpacks.cpp:220) for the batched device path.
Every product is ``torch.bmm`` in true f32 (the package turns TF32 off,
_device.py), on the device of the stack: a CUDA stack runs on the card,
a CPU stack on the CPU, and nothing moves it.

Where the JAX solver lets a failed Cholesky produce NaN (which the
host Rayleigh-Ritz then raises on, and its residual guard would miss,
since NaN > tol is false), this one uses ``cholesky_ex``: a matrix
whose factorization fails is carried through unchanged, flagged, and
reported with infinite residuals, so that callers send it to the exact
host solver.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from saamge_tpu_torch.utils.logging import TIMERS

# max relative eigenpair residual (||Mx - wx|| / sigma) tolerated from
# the filtered solver; converged output sits at ~1e-4 (f32 + leakage).
# A spectrum clustered at the filter edge shows up here, and callers
# re-solve such an AE exactly on the host rather than silently dropping
# a direction (reference spectral.hpp:32-60)
FILTER_RESIDUAL_TOL = 0.05


def _cheb_filter(M, X, a, sigma, degree: int):
    """X <- T_degree(L) X with L = (2 M - (a+sigma) I) / (sigma - a):
    |T_d| <= 1 on [a, sigma], grows like exp(2 d sqrt(a'/..)) below a."""
    c = ((a + sigma) / 2.0)[:, None, None]
    h = ((sigma - a) / 2.0)[:, None, None]

    def lmap(V):
        return (torch.bmm(M, V) - c * V) / h

    T0 = X
    T1 = lmap(X)
    for _ in range(degree - 1):
        T0, T1 = T1, 2.0 * lmap(T1) - T0
    return T1


def _orthonormalize(X, eps: float = 1e-6):
    """Cholesky QR with a trace-scaled ridge (approximate at f32; the
    final Rayleigh-Ritz is generalized with the true Gram matrix).
    Returns ``(Q, bad)``: ``bad`` (B,) marks the matrices whose Gram
    factorization failed (an all-zero block has a zero ridge); their X
    passes through unchanged so that no NaN reaches the others."""
    G = torch.bmm(X.transpose(1, 2), X)
    m = X.shape[2]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1)
    G = G + (eps * tr / m)[:, None, None] * eye
    L, info = torch.linalg.cholesky_ex(G)
    bad = info != 0
    L = torch.where(bad[:, None, None], eye, L)
    Xt = torch.linalg.solve_triangular(L, X.transpose(1, 2), upper=False)
    return Xt.transpose(1, 2), bad


def _gram(X, MX=None):
    """X^T MX (or X^T X) per matrix."""
    return torch.bmm(X.transpose(1, 2), X if MX is None else MX)


def _first(M, X0, a_frac: float, degree: int):
    """The first round: sigma, the filter at a = a_frac sigma, and the
    projected T for the host Ritz estimate of the cutoff."""
    sigma = M.abs().sum(2).amax(1) * 1.01
    a = a_frac * sigma
    X, bad0 = _orthonormalize(X0)
    X = _cheb_filter(M, X, a, sigma, degree)
    X, bad1 = _orthonormalize(X)
    return X, sigma, _gram(X, torch.bmm(M, X)), bad0 | bad1


def _rest(M, X, a, sigma, degree: int, rounds: int):
    """The other rounds at the adaptive cutoff, then T and G."""
    bad = torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    for _ in range(rounds - 1):
        X, b = _orthonormalize(_cheb_filter(M, X, a, sigma, degree))
        bad |= b
    return X, _gram(X, torch.bmm(M, X)), _gram(X), bad


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def batched_smallest_eigs(M, m: int, degree: int = 16, rounds: int = 4,
                          a_frac: float = 0.05, seed: int = 0, rng=None):
    """Approximate the m smallest eigenpairs of each SPD matrix in the
    (B, n, n) f32 stack ``M`` (on the card or the CPU).  Returns (evals
    (B, m) f64 host, X (B, n, m) on M's device, res (B, m) f64 host) with
    eigenvalues ascending; res is the RELATIVE eigenpair residual
    ||M x - w x|| / sigma per pair (sigma = Gershgorin bound), the guard
    against silently dropped directions near a borderline theta cut
    (reference spectral.hpp:32-60).  A matrix the solver could not
    handle (a failed Cholesky, a non-finite projection) gets evals and
    res of +inf.  Callers route matrices whose sub-cut pairs exceed a
    few percent, or are not finite, to the exact path.

    The start block is ``rng.standard_normal((B, n, m))`` (``rng``
    defaults to ``np.random.default_rng(seed)``), the JAX solver's draw.
    Chunks of one batch that draw in order from one generator get the
    rows that the whole batch would."""
    B, n, _ = M.shape
    if rng is None:
        rng = np.random.default_rng(seed)
    X0 = torch.as_tensor(rng.standard_normal((B, n, m)),
                         dtype=M.dtype).to(M.device)
    with TIMERS.phase("setup.filtered_eig.first"):
        X, sigma, T1, bad = _first(M, X0, a_frac, degree)
        del X0
        T1h = _host(T1)
        sigma_h = _host(sigma)
        ok = np.isfinite(T1h).all(axis=(1, 2)) & ~bad.cpu().numpy()
        T1h[~ok] = 0.0
        ew = np.linalg.eigvalsh(0.5 * (T1h + T1h.transpose(0, 2, 1)))
    # adaptive cutoff: just above the m-th Ritz value but CLAMPED well
    # below sigma -- with m much wider than the wanted low cluster the
    # m-th Ritz value sits in the spectral bulk, and a cutoff near sigma
    # makes the filter a no-op.  The clamp keeps exponential suppression
    # of the bulk; the low cluster (what the theta cut uses) converges
    # fastest.
    a = np.minimum(np.maximum(ew[:, -1] * 1.5, 1e-8), sigma_h * 0.05)
    with TIMERS.phase("setup.filtered_eig.rest"):
        X, T, G, bad2 = _rest(M, X, torch.as_tensor(a, dtype=M.dtype)
                              .to(M.device), sigma, degree, rounds)
        T_host, G_host = _host(T), _host(G)
        ok &= ~bad2.cpu().numpy() & np.isfinite(T_host).all(axis=(1, 2)) \
            & np.isfinite(G_host).all(axis=(1, 2))
    # generalized host RR: the Cholesky-QR orthonormalization is
    # approximate, so solve T z = w G z per matrix (scipy, tiny matrices)
    w = np.full((B, m), np.inf)
    V = np.broadcast_to(np.eye(m), (B, m, m)).copy()
    for k in np.flatnonzero(ok):
        Gk = 0.5 * (G_host[k] + G_host[k].T)
        Gk = Gk + 1e-12 * np.trace(Gk) / m * np.eye(m)
        try:
            w[k], V[k] = sla.eigh(0.5 * (T_host[k] + T_host[k].T), Gk)
        except np.linalg.LinAlgError:     # G not positive definite
            ok[k] = False
    Xr = torch.bmm(X, torch.as_tensor(V, dtype=M.dtype).to(M.device))
    w_dev = torch.as_tensor(np.where(ok[:, None], w, 0.0),
                            dtype=M.dtype).to(M.device)
    res = _host(_residuals(M, Xr, w_dev)) \
        / np.maximum(sigma_h[:, None], 1e-30)
    res[~ok] = np.inf
    return w, Xr, res


def _residuals(M, X, w):
    """Per-pair residual norms ||M x_k - w_k x_k||_2, (B, m)."""
    R = torch.bmm(M, X) - X * w[:, None, :]
    nx = torch.sqrt(torch.clamp((X * X).sum(1), min=1e-30))
    return torch.sqrt((R * R).sum(1)) / nx


def measure_eig_throughput(B: int, n: int, m: int = 64, degree: int = 16,
                           reps: int = 12, seed: int = 0, device="cuda"):
    """GFLOP/s of the filter round (Chebyshev filter + Cholesky-QR, the
    core of batched_smallest_eigs) at the (B, n, m) batch shape, beside
    ``torch.bmm`` of the same (B, n, n) x (B, n, m) shapes in f32, timed
    on the card with CUDA events (three windows of ``reps`` rounds, and
    of ``reps`` x ``degree`` products; the median window counts).
    A device that is not a card raises: this is a measurement."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_eig_throughput times the card; got {dev}")
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((B, n, n), dtype=np.float32)) \
        .to(dev)
    M = (A + A.transpose(1, 2)) / (2.0 * np.sqrt(n)) \
        + 2.0 * torch.eye(n, dtype=torch.float32, device=dev)
    del A
    X0 = torch.as_tensor(rng.standard_normal((B, n, m), dtype=np.float32)) \
        .to(dev)
    sigma = M.abs().sum(2).amax(1) * 1.01
    a = 0.05 * sigma
    inv_sigma = (1.0 / sigma)[:, None, None]

    def filter_round(X):
        return _orthonormalize(_cheb_filter(M, X, a, sigma, degree))[0]

    def products(X):
        # scaled by 1 / sigma: the iterate neither overflows nor decays
        # into denormals over the window
        for _ in range(degree):
            X = torch.bmm(M, X) * inv_sigma
        return X

    def window_ms(fn, calls):
        fn(X0)                                   # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        for _ in range(3):
            X = X0
            start.record()
            for _ in range(reps):
                X = fn(X)
            end.record()
            torch.cuda.synchronize(dev)
            out.append(start.elapsed_time(end) / calls)
        return out

    with torch.cuda.device(dev):
        round_draws = window_ms(filter_round, reps)
        mm_draws = window_ms(products, reps * degree)
    dt_eig = float(np.median(round_draws)) * 1e-3
    dt_mm = float(np.median(mm_draws)) * 1e-3
    flops_round = B * (degree * 2 * n * n * m + 3 * n * m * m)
    flops_mm = B * 2 * n * n * m
    eig_gflops = flops_round / dt_eig / 1e9
    bmm_gflops = flops_mm / dt_mm / 1e9
    return {
        "shape": [B, n, m], "degree": degree,
        "eig_gflops": eig_gflops, "bmm_gflops": bmm_gflops,
        "eig_bmm_fraction": eig_gflops / bmm_gflops,
        "round_ms": dt_eig * 1e3, "round_ms_draws": round_draws,
        "bmm_ms": dt_mm * 1e3, "bmm_ms_draws": mm_draws,
        "flops_round": flops_round,
    }
