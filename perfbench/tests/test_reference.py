"""The plain float64 reference against the port's own assembly
(fem/assemble.py) at small n: the operator, the load vectors, the
coefficient law of api.flagship_problem and api.general_problem."""

import numpy as np
import pytest
import torch

from perfbench.reference import q1_diffusion as q


def assembled(n, coef, rhs):
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, _, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=rhs, ess_attr_marker=ess)
    return A, b, ess_dofs


@pytest.mark.parametrize("n", [4, 7])
def test_operator_and_load_against_the_port_assembly(n):
    coef = q.coefficients(n, 2.0, 2 ** 31 + 11)
    f = q.block_source(n, 3, np.random.default_rng(5))
    A, b, ess = assembled(n, coef, f)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    y = q.Q1Operator(n, coef)(torch.as_tensor(x)).numpy()
    assert np.abs(y - A @ x).max() <= 1e-13 * np.abs(A @ x).max()
    assert np.abs(q.load_vector(n, f) - b).max() <= 1e-15 * np.abs(b).max()
    assert np.array_equal(np.sort(ess),
                          np.flatnonzero(q.boundary_mask(n).numpy()))


def test_constant_load_is_the_program_load():
    n = 6
    _, b, _ = assembled(n, 1.0, 1.0)
    assert np.abs(q.load_vector(n, np.ones(n ** 3)) - b).max() <= 1e-18


def test_coefficient_law_matches_the_program_problem():
    """The field the reference draws from a seed is the one
    api.flagship_problem assembles from it: the program's operator equals
    the reference's."""
    from saamge_tpu_torch.api import flagship_problem
    n, seed = 8, 2 ** 32 + 3
    ml, b, _, _ = flagship_problem(n=n, brick=4, supers=(2, 2, 2), seed=seed)
    A = ml.levels[0].A
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    op = q.Q1Operator(n, q.coefficients(n, 2.0, seed))
    y = op(torch.as_tensor(x)).numpy()
    assert np.abs(y - A @ x).max() <= 1e-13 * np.abs(A @ x).max()


def test_block_sums_and_residuals():
    n = 5
    v = torch.arange((n + 1) ** 3, dtype=torch.float64)
    s = q.block_sums(v, n, 2)
    assert s.shape == (27,) and float(s.sum()) == float(v.sum())
    op = q.Q1Operator(n, q.coefficients(n, 1.0, 3))
    x = torch.randn((n + 1) ** 3, dtype=torch.float64)
    x[op.ess] = 0
    r = q.residuals(op, op(x), x, 2)
    assert r["res_fine"] <= 1e-15 and r["res_coarse"] <= 1e-15
    r = q.residuals(op, op(x), torch.zeros_like(x), 2)
    assert r["res_fine"] == pytest.approx(1.0)


def test_element_matrix_rows_sum_to_zero_and_scale():
    K = q.element_matrix(4)
    assert np.abs(K.sum(axis=1)).max() <= 1e-14
    assert K[0, 0] == pytest.approx(1.0 / 3.0 / 4)
