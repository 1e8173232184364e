"""The V-cycle (host reference implementation).

tg_cycle_atb (tg.cpp:91-131): pre-smooth, restrict residual, coarse solve,
prolongate correction, post-smooth.  The production path is the jitted JAX
version in saamge_tpu_torch.solve.compiled; this numpy twin is the semantic
reference the tests pin down.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.solve import smoothers


def tg_cycle(A: sp.csr_matrix, tg_data, b: np.ndarray,
             x: np.ndarray, mu: int = 1) -> None:
    """One mu-cycle of ``tg_data`` applied in place to x: mu=1 the V-cycle
    (tg_cycle_atb, tg.cpp:91-131), mu=2 the W-cycle (solve_spd_Wcycle,
    solve.cpp:339-360): the coarse correction is applied mu times with a
    residual update in between."""
    pd = tg_data.poly_data
    x[:] = smoothers.sym_poly(A, b, x, pd)
    for cycle in range(mu):
        res = b - A @ x
        resc = tg_data.restr @ res
        xc = np.zeros(tg_data.Ac.shape[0])
        tg_data.coarse_solver.mult(resc, xc)
        x += tg_data.interp @ xc
    x[:] = smoothers.sym_poly(A, b, x, pd)


class VCycleSolver:
    """mfem::Solver-style wrapper (solve.cpp:291-325)."""

    def __init__(self, tg_data, iterative_mode: bool = False, mu: int = 1):
        self.tg_data = tg_data
        self.iterative_mode = iterative_mode
        self.mu = mu                       # 1 = V-cycle, 2 = W-cycle
        self.A = None

    def set_operator(self, A: sp.csr_matrix) -> None:
        self.A = A

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        if not self.iterative_mode:
            x[:] = 0.0
        tg_cycle(self.A, self.tg_data, b, x, self.mu)


def tg_solve_stationary(A, tg_data, b, x, maxiter=100, rtol=1e-12, atol=0.0,
                        reducttol=1.0):
    """Stationary iteration with (B^{-1}r, r) convergence monitoring
    (tg_solve, tg.cpp:214-301).  Returns +iters on success, -iters on
    failure (max iters or reduction-factor breach)."""
    def calc_rr():
        res = b - A @ x
        psres = np.zeros_like(x)
        tg_cycle(A, tg_data, res, psres)
        return float(psres @ res), res

    rr, res = calc_rr()
    end = max(rtol * rr, atol)
    rr_prev = 1.0
    i = 1
    while i <= maxiter and rr > end:
        if i > 2 and rr / rr_prev > reducttol:
            return -(i - 1)
        x_prev = x.copy()
        tg_cycle(A, tg_data, b, x)
        rr_prev = rr
        # cheap recalculation (tg_recalc_res_tgprod, tg.cpp:171)
        rr = float((x - x_prev) @ res)
        res = b - A @ x
        i += 1
    if rr > end:
        return -(i - 1)
    return i - 1
