"""Preconditioned conjugate gradients (host reference implementation).

Mirrors mfem::CGSolver::Mult convergence semantics, which is what all the
reference drivers use for the outer solve (mltest.cpp:762-779): converge when
(B r, r) <= max(rel_tol^2 * (B r0, r0), abs_tol^2); the returned iteration
count is the number the drivers print ("Outer PCG converged in N
iterations").  Also provides kalchev_pcg's zero-RHS energy-norm mode
(mfem_addons.cpp:106-230).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class PCGResult:
    converged: bool
    iterations: int
    final_norm: float
    x: np.ndarray


def pcg(A, b: np.ndarray, precond: Callable[[np.ndarray], np.ndarray],
        x0: Optional[np.ndarray] = None, rel_tol: float = 1e-6,
        abs_tol: float = 0.0, max_iter: int = 1000,
        verbose: bool = False) -> PCGResult:
    """MFEM CGSolver semantics (rel_tol is squared internally)."""
    n = len(b)
    x = np.zeros(n) if x0 is None else x0.copy()
    if x0 is None or not np.any(x0):
        r = b.copy()
    else:
        r = b - A @ x
    z = precond(r)
    d = z.copy()
    nom0 = nom = float(z @ r)
    r0 = max(nom0 * rel_tol * rel_tol, abs_tol * abs_tol)
    if nom <= r0:
        return PCGResult(True, 0, nom, x)
    Ad = A @ d
    den = float(d @ Ad)
    for i in range(1, max_iter + 1):
        alpha = nom / den
        x += alpha * d
        r -= alpha * Ad
        z = precond(r)
        betanom = float(r @ z)
        if verbose:
            print(f"   Iteration : {i:4d}  (B r, r) = {betanom:g}")
        if betanom < 0.0:
            return PCGResult(False, i, betanom, x)
        if betanom <= r0:
            return PCGResult(True, i, betanom, x)
        beta = betanom / nom
        d = z + beta * d
        Ad = A @ d
        den = float(d @ Ad)
        nom = betanom
        if den <= 0.0:
            return PCGResult(False, i, betanom, x)
    return PCGResult(False, max_iter, nom, x)
