"""The port's copy of the FOSLS Helmholtz block system
(saamge_tpu_torch/fem/helmholtz.py) against the JAX package's
(tests/test_helmholtz.py): the same system, entry for entry, and the
same SAAMGeAlgPC iteration bounds; the two-level device solve runs
through the port's compiled path on the CPU."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from saamge_tpu.fem.helmholtz import ls_helmholtz_system as jax_system

from saamge_tpu_torch.config import SolverOptions
from saamge_tpu_torch.fem.helmholtz import ls_helmholtz_system

torch.set_num_threads(1)


@pytest.mark.parametrize("eliminate_bc", [True, False])
def test_system_identical_to_jax_package(eliminate_bc):
    """Reference: 803 dofs eliminated (867 = 289 + 578 un-eliminated)."""
    mine = ls_helmholtz_system(k=-20.0, eliminate_bc=eliminate_bc)
    ref = jax_system(k=-20.0, eliminate_bc=eliminate_bc)
    assert mine.A.shape[0] == (803 if eliminate_bc else 867)
    assert (mine.A != ref.A).nnz == 0
    assert np.array_equal(mine.b, ref.b)


def test_system_spd_and_solvable():
    sys = ls_helmholtz_system(k=-20.0)
    A = sys.A
    assert abs(A - A.T).max() < 1e-10
    w = spla.eigsh(A, k=1, which="SA", return_eigenvectors=False)
    assert w[0] > 0
    x = spla.spsolve(A.tocsc(), sys.b)
    u, q = sys.recover(x)
    assert np.isfinite(u).all() and np.isfinite(q).all()


@pytest.mark.parametrize("k,max_iters", [(-20.0, 56), (-50.0, 115)])
def test_ls_helmholtz_algebraic_pcg(k, max_iters):
    """csv_data baselines: 56 iterations at k=-20, 115 at k=-50."""
    from saamge_tpu_torch.api import SAAMGeAlgPC
    from saamge_tpu_torch.solve.pcg import pcg
    sys = ls_helmholtz_system(k=k)
    opts = SolverOptions(theta=0.003, nu_relax=3, correct_nulspace=False,
                         first_elems_per_agg=256, rtol=0.0, maxiter=600)
    pc = SAAMGeAlgPC(sys.A, opts, eliminate_dof0=False)
    res = pcg(sys.A, sys.b, pc.mult, rel_tol=0.0, abs_tol=1e-10,
              max_iter=600)
    assert res.converged
    assert res.iterations <= max_iters + int(0.15 * max_iters), \
        res.iterations
    x_ref = spla.spsolve(sys.A.tocsc(), sys.b)
    assert np.linalg.norm(res.x - x_ref) / np.linalg.norm(x_ref) < 1e-5


def test_ls_helmholtz_compiled_solve():
    """The algebraic preconditioner's two-grid data through the port's
    compiled PCG (f64, CPU) on the FOSLS monolithic system."""
    from saamge_tpu_torch.api import SAAMGeAlgPC
    from saamge_tpu_torch.solve.compiled import compile_two_level, pcg_solve
    sys_ = ls_helmholtz_system(k=-20.0)
    opts = SolverOptions(theta=0.003, correct_nulspace=False,
                         first_elems_per_agg=256, rtol=0.0, maxiter=600)
    pc = SAAMGeAlgPC(sys_.A, opts, eliminate_dof0=False)
    h = compile_two_level(sys_.A, pc.tg, dtype=torch.float64, device="cpu")
    x, it, _ = pcg_solve(h, torch.as_tensor(sys_.b), rel_tol=1e-12,
                         max_iter=600)
    x = x.numpy()
    rel = np.linalg.norm(sys_.b - sys_.A @ x) / np.linalg.norm(sys_.b)
    assert rel < 1e-6
    assert int(it) <= 60
