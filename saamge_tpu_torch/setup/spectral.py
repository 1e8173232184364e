"""Per-AE generalized eigenproblems defining the coarse space.

Host path for the reference's Eigensolver (spectral.cpp:89-237):
solve ``A_T x = lambda B_T x`` with B = the weighted l1-smoother diagonal
(mbox_snd_D_sparse_from_sparse, mbox.cpp:913: d_i = sum_j |a_ij|
sqrt(a_ii/a_jj)), keep eigenvectors with lambda <= theta * lmax (lmax == 1 by
the weighted-l1 choice), at least one (xpacks_calc_lower_eigens_dense,
xpacks.cpp:224-315).

Since B is diagonal the generalized problem reduces to the standard
symmetric eigenproblem of D^{-1/2} A D^{-1/2}; that is also exactly the form
the batched device path uses (jnp.linalg.eigh over padded AE stacks — see
saamge_tpu.ops.batched_eig).

The 'iterative' mode reproduces the reference's ARPACK configuration for
large AEs (spectral.cpp:240-322): at most ``max_vectors`` (default 10)
smallest eigenpairs, vectors kept while lambda < theta (strict), at least
``min_vectors`` = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

ARPACK_SIZE_THRESHOLD = 64  # interp.hpp:104
MAX_ARPACK_VECTORS = 10     # spectral.cpp:56


def weighted_l1_diag(A) -> np.ndarray:
    """d_i = sum_j |a_ij| sqrt(a_ii / a_jj) over the stored pattern.

    For dense input all entries participate; entries that are exactly zero
    contribute nothing either way, so pattern vs dense is immaterial.
    Accepts dense arrays or sparse CSR (large AEs are stored sparse)."""
    if sp.issparse(A):
        diag = A.diagonal()
        assert (diag > 0).all(), "non-positive diagonal in AE matrix"
        s = np.sqrt(diag)
        return (abs(A) @ (1.0 / s)) * s
    diag = np.diagonal(A)
    assert (diag > 0).all(), "non-positive diagonal in AE matrix"
    s = np.sqrt(diag)
    return (np.abs(A) / s[None, :]).sum(axis=1) * s


@dataclasses.dataclass
class EigensolverStats:
    count_solves: int = 0
    count_direct_solves: int = 0
    count_max_used: int = 0
    smallest_eigenvalue_skipped: float = np.inf


class Eigensolver:
    """Dispatches direct (small) vs truncated (large) local eigensolves
    (spectral.cpp:89-116)."""

    # Above this size the iterative path is used even when the caller asked
    # for direct solves: a dense eigh here costs minutes and the reference's
    # own design bounds local-solve cost with ARPACK (interp.hpp:104).
    AUTO_TRUNCATE_SIZE = 1024

    def __init__(self, threshold: int = ARPACK_SIZE_THRESHOLD,
                 use_truncated: bool = True,
                 max_vectors: int = MAX_ARPACK_VECTORS,
                 shift_invert: str = "auto"):
        self.threshold = min(threshold if use_truncated
                             else np.iinfo(np.int32).max,
                             self.AUTO_TRUNCATE_SIZE)
        self.max_vectors = max_vectors
        # shift-invert hardening of the truncated path (the reference's
        # ARPACK mode IS shift-invert, ARSymGenEig arpacks.cpp:220-240):
        # 'auto' re-solves with an exact-factorization preconditioner
        # whenever plain LOBPCG's residuals leave the theta cut in doubt
        # (clustered low spectra on high-contrast AEs); 'always'/'never'
        # force the choice
        assert shift_invert in ("auto", "always", "never")
        self.shift_invert = shift_invert
        self.stats = EigensolverStats()

    def solve(self, A: np.ndarray, theta: float,
              B: Optional[np.ndarray] = None):
        """Returns (cut_evects (n, m), skipped_eigenvalue, B_diag).

        ``skipped_eigenvalue`` is the smallest eigenvalue NOT taken (the
        value SolveDirect returns through theta for adaptive theta
        suggestion) — the largest eigenvalue when everything is taken."""
        n = A.shape[0]
        self.stats.count_solves += 1
        if B is None:
            B = weighted_l1_diag(A)
        if n <= self.threshold:
            self.stats.count_direct_solves += 1
            return self._solve_direct(A, B, theta)
        return self._solve_truncated(A, B, theta)

    def _eig_all(self, A, B: np.ndarray):
        if sp.issparse(A):
            A = A.toarray()
        dhalf = 1.0 / np.sqrt(B)
        M = dhalf[:, None] * A * dhalf[None, :]
        M = 0.5 * (M + M.T)
        evals, Y = np.linalg.eigh(M)
        return evals, dhalf[:, None] * Y

    # For AEs above this size the direct path computes only the lowest
    # SUBSET_K eigenpairs (dsyevr range mode — exactly the reference's
    # xpacks_calc_lower_eigens_dense, xpacks.hpp:120) and falls back to the
    # full solve in the rare case the theta cut wants them all.
    SUBSET_MIN_N = 128
    SUBSET_K = 24

    def _solve_direct(self, A, B, theta):
        n = A.shape[0]
        if sp.issparse(A):
            A = A.toarray()
        if n > self.SUBSET_MIN_N:
            import scipy.linalg as sla
            dhalf = 1.0 / np.sqrt(B)
            M = dhalf[:, None] * A * dhalf[None, :]
            M = 0.5 * (M + M.T)
            k = min(self.SUBSET_K, n)
            evals, Y = sla.eigh(M, subset_by_index=[0, k - 1])
            if evals[-1] > theta:            # cut is inside the subset
                X = dhalf[:, None] * Y
                m = max(int(np.searchsorted(evals, theta, side="right")), 1)
                return X[:, :m], float(evals[m] if m < k else evals[-1]), B
        evals, X = self._eig_all(A, B)
        lmax = 1.0
        m = int(np.searchsorted(evals, theta * lmax, side="right"))
        m = max(m, 1)  # at least one (xpacks.cpp atleast_one)
        skipped = evals[m] if m < len(evals) else evals[-1]
        return X[:, :m], float(skipped), B

    def _solve_truncated(self, A, B, theta):
        """ARPACK-mode semantics (spectral.cpp:271-296): <= max_vectors
        smallest pairs, keep while eval < theta strictly, at least one.

        Computed iteratively with LOBPCG on the scaled operator
        M = B^-1/2 A B^-1/2 (the ARPACK shift-invert analog; tol 1e-4 and
        iteration cap follow spectral.cpp:272-274), falling back to the
        dense path for small/ill-posed cases."""
        n = A.shape[0]
        k = min(self.max_vectors, n)
        evals = X = None
        if n >= 4 * k:
            import scipy.sparse.linalg as spla
            dhalf = 1.0 / np.sqrt(B)
            if sp.issparse(A):
                Dh = sp.diags(dhalf)
                M = (Dh @ A @ Dh).tocsr()
                M = (0.5 * (M + M.T)).tocsr()
            else:
                M = dhalf[:, None] * A * dhalf[None, :]
                M = 0.5 * (M + M.T)
            rng = np.random.default_rng(n)
            V0 = rng.standard_normal((n, k))
            import warnings
            try:
                evals = None
                if self.shift_invert != "always":
                    # lobpcg warns (rather than raises) when it exits at
                    # maxiter; that is the expected outcome the residual
                    # guard below handles — keep it out of the user's
                    # warning filters so behavior is filter-independent
                    with np.errstate(all="ignore"), \
                            warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        w, V = spla.lobpcg(M, V0, largest=False, tol=1e-4,
                                           maxiter=200)
                    order = np.argsort(w)
                    evals = w[order]
                    V = V[:, order]
                # eigenvalue-uncertainty guard: |lambda_hat - lambda| <=
                # ||M v - lambda_hat v|| for symmetric M; when that bound
                # is a significant fraction of theta the cut itself is in
                # doubt (clustered low spectra under high contrast stall
                # unpreconditioned LOBPCG at tol 1e-4)
                need_si = self.shift_invert == "always"
                if (self.shift_invert == "auto" and evals is not None):
                    Msp = M if sp.issparse(M) else None
                    R = (M @ V if Msp is None else Msp @ V) - V * evals
                    res = np.linalg.norm(R, axis=0) \
                        / np.maximum(np.linalg.norm(V, axis=0), 1e-300)
                    need_si = bool(res.max() > 0.05 * theta)
                if need_si:
                    # exact-factorization preconditioner = the shift-
                    # invert analog at sigma=0 (tiny Tikhonov shift keeps
                    # the SPSD factor nonsingular); convergence is then
                    # gap-independent.  LOBPCG's own tol is set to what the
                    # guard actually needs (ARPACK's discipline: request
                    # only the accuracy the cut requires, spectral.cpp:
                    # 271-274) and its best iterate is accepted silently —
                    # the residual guard below re-checks it.
                    Msp = (M if sp.issparse(M)
                           else sp.csr_matrix(M)).tocsc()
                    tau = 1e-10 * max(abs(Msp).max(), 1.0)
                    lu = spla.splu(Msp + tau * sp.eye(n, format="csc"))
                    prec = spla.LinearOperator((n, n), matvec=lu.solve,
                                               matmat=lu.solve)
                    si_tol = max(1e-10, 0.01 * theta)
                    with np.errstate(all="ignore"), \
                            warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        w, V = spla.lobpcg(M, V0, M=prec, largest=False,
                                           tol=si_tol, maxiter=100)
                    order = np.argsort(w)
                    evals = w[order]
                    V = V[:, order]
                    # re-apply the guard to the best iterate; if the cut
                    # is still in doubt, fall back to the dense path
                    R = (M @ V) - V * evals
                    res = np.linalg.norm(R, axis=0) \
                        / np.maximum(np.linalg.norm(V, axis=0), 1e-300)
                    if res.max() > 0.05 * theta:
                        evals = None
                if evals is not None:
                    X = dhalf[:, None] * V
            except Exception:
                evals = None
        if evals is None:
            evals_full, X_full = self._eig_all(A, B)
            evals, X = evals_full[:k], X_full[:, :k]
        got = 1
        for ev in range(1, k):
            if evals[ev] < theta:
                got += 1
        if got == k:
            self.stats.count_max_used += 1
            skipped = evals[k - 1]  # nothing reliable was skipped
        else:
            skipped = evals[got]
            self.stats.smallest_eigenvalue_skipped = min(
                self.stats.smallest_eigenvalue_skipped, float(skipped))
        return X[:, :got], float(max(skipped, 0.0)), B


def schur_eigensolve(A_AE: np.ndarray, agg_ids: np.ndarray, theta: float,
                     max_vectors: int = 0):
    """Legacy aggregate Schur-complement eigensolve with minimal-energy
    extension (spect_schur_local_prob_solve_sparse, spectral.cpp:405 +
    spect_schur_augment_transf, spectral.cpp:325): partition the AE
    stiffness into aggregate ('a') and rest ('r') dofs,

        S = A_aa - A_ar A_rr^{-1} A_ra,

    solve S w = lambda B_S w (B_S the weighted-l1 diagonal of S), keep
    lambda <= theta (at least one), and extend each eigenvector into the
    full AE by the minimal-energy (harmonic) extension
    w_r = -A_rr^{-1} A_ra w_a.

    Returns (n_AE, m) full-AE vectors."""
    n = A_AE.shape[0]
    a = np.asarray(agg_ids, dtype=np.int64)
    mask = np.zeros(n, dtype=bool)
    mask[a] = True
    r = np.flatnonzero(~mask)
    Aaa = A_AE[np.ix_(a, a)]
    if len(r):
        Aar = A_AE[np.ix_(a, r)]
        Arr = A_AE[np.ix_(r, r)]
        Ext = -np.linalg.solve(Arr, Aar.T)          # (r, a)
        S = Aaa + Aar @ Ext
        S = 0.5 * (S + S.T)
    else:
        Ext = None
        S = Aaa
    eig = Eigensolver(use_truncated=max_vectors > 0,
                      max_vectors=max_vectors or MAX_ARPACK_VECTORS)
    wa, skipped, _ = eig.solve(S, theta)
    out = np.zeros((n, wa.shape[1]))
    out[a] = wa
    if Ext is not None:
        out[r] = Ext @ wa
    return out, skipped
