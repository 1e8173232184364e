"""Double cycle: two coarse solvers at one level combined multiplicatively.

Reference: DoubleCycle.{hpp,cpp} — at the finest coarse level, combine the
usual multilevel V-cycle (``outer``) with a CorrectNullspace correction
(``inner``) around it (DoubleCycle::Mult, DoubleCycle.cpp:61-100).

We implement the standard symmetrized multiplicative composition with
accumulation of corrections,

    xc  = B_outer rc
    xc += B_inner (rc - Ac xc)
    xc += B_outer (rc - Ac xc)

which keeps the composed operator symmetric (PCG-safe).  (The reference's
literal code overwrites the correction between the stages because its
sub-solvers run with iterative_mode=false — capability-wise both are "two
coarse solvers multiplicatively at one level"; the accumulating form is the
mathematically standard one.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.solve import smoothers
from saamge_tpu_torch.solve.coarse import CorrectNullspace, VCycleCoarseSolver


class DoubleCycle:
    """Preconditioner combining the coarse V-cycle hierarchy with a
    CorrectNullspace inner solver at the finest coarse level."""

    def __init__(self, A: sp.csr_matrix, ml):
        tg = ml.finest.tg_data
        assert tg.scaling_P is not None, \
            "double cycle needs scaling_P on the finest level " \
            "(use_double_cycle=True during setup)"
        assert len(ml.levels) >= 2, "double cycle needs >= 3 levels"
        self.A = A
        self.Ac = tg.Ac
        self.interp = tg.interp
        self.restr = tg.restr
        self.poly_data = tg.poly_data
        self.inner = CorrectNullspace(tg.Ac, tg.scaling_P,
                                      smoother_steps=2, smooth_phat=False,
                                      v_cycle=True)
        self.outer = VCycleCoarseSolver(ml.levels[1].tg_data, tg.Ac)

    def set_operator(self, A: sp.csr_matrix) -> None:
        self.A = A

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        x[:] = 0.0
        x[:] = smoothers.sym_poly(self.A, b, x, self.poly_data)
        res = b - self.A @ x
        rc = self.restr @ res

        xc = np.zeros(self.Ac.shape[0])
        self.outer.mult(rc, xc)
        corr = np.zeros_like(xc)
        self.inner.mult(rc - self.Ac @ xc, corr)
        xc += corr
        corr[:] = 0.0
        self.outer.mult(rc - self.Ac @ xc, corr)
        xc += corr

        x += self.interp @ xc
        x[:] = smoothers.sym_poly(self.A, b, x, self.poly_data)
