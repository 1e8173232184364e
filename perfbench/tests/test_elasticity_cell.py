"""The elasticity cell's own files: the plain reference
(reference/q1_elasticity.py) against hand counts and its own algebra, the
fine chain's work count (harness/roofline_elasticity.py) against the
assembled operator, and a tiny-n rehearsal of the cell on the CPU with the
port's plain kernels, with each fault of test_faults.py planted."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.harness import spec
from perfbench.harness.roofline_elasticity import (elasticity_nnz,
                                                   elasticity_smooth_work)
from perfbench.reference import q1_elasticity as q
from perfbench.tests.test_faults import altered, not_converged, unchanged

CELL = "elasticity.rhs_stream"
# a cell cut to n=8 with agglomerates of 32 / 8 elements, check blocks of
# n / 4 elements as the cell's 10 at n=40
TINY = {"n": 8, "first_elems_per_agg": 32, "elems_per_agg": 8}


def tiny_cell():
    c = spec.find_cell(CELL)
    return dataclasses.replace(c, config={**c.config, **TINY},
                               limits={**c.limits, "check_block": 2})


def dense(op, ndof):
    return torch.stack([op(e) for e in torch.eye(ndof, dtype=torch.float64)],
                       1)


def test_element_matrix_has_the_rigid_body_modes():
    """Symmetric, positive semidefinite, with exactly the six rigid-body
    modes (three translations, three rotations) as its null space."""
    n = 4
    K = q.element_matrix(n)
    assert np.abs(K - K.T).max() < 1e-14 * np.abs(K).max()
    w = np.linalg.eigvalsh(K)
    assert w.min() > -1e-12 * w.max()
    assert int((w < 1e-10 * w.max()).sum()) == 6
    h = 1.0 / n
    corners = np.array(q.CORNERS, dtype=float) * h
    modes = []
    for d in range(3):
        t = np.zeros((8, 3))
        t[:, d] = 1.0
        modes.append(t.reshape(-1))
    for axis in np.eye(3):
        modes.append(np.cross(axis, corners).reshape(-1))
    R = np.stack(modes, 1)
    assert np.linalg.matrix_rank(R) == 6
    assert np.abs(K @ R).max() < 1e-12 * np.abs(K).max()


def test_clamped_operator_is_spd():
    """Clamped on the x = 0 face the operator is symmetric positive
    definite, and the clamped rows are diagonal."""
    n = 2
    op = q.Q1Elasticity(n, q.coefficients(n, 2.0, 5))
    A = dense(op, q.ndof({"n": n}))
    assert float((A - A.T).abs().max()) < 1e-12 * float(A.abs().max())
    assert float(torch.linalg.eigvalsh(A).min()) > 0
    ess = op.ess
    off = A[ess] - torch.diag(torch.diagonal(A))[ess]
    assert float(off.abs().max()) == 0.0


def test_loads_and_dofs():
    """ndof = 3 (n+1)^3; the constant load f = (0, 0, -1) integrates to
    -1 over the cube less what lands on the clamped face (four of eight
    corners of each of the n^2 elements there: 1 / (2 n)); a block
    source is constant on its cubes with three components a cube."""
    n = 6
    p = {"n": n, "contrast": 2.0, "clamp": "x0"}
    assert q.ndof(p) == 3 * 7 ** 3
    b = q.load_vector(p, q.constant_source(p)).reshape(-1, 3)
    assert b.shape == ((n + 1) ** 3, 3)
    assert np.allclose(b.sum(0), [0.0, 0.0, -1.0 + 1.0 / (2 * n)])
    assert not b.reshape(n + 1, n + 1, n + 1, 3)[0].any()
    f = q.block_source(p, 4, np.random.default_rng(1))
    assert f.shape == (n ** 3, 3)
    cubes = f.reshape(n, n, n, 3)
    assert np.array_equal(cubes[:4, :4, :4], np.broadcast_to(
        cubes[0, 0, 0], (4, 4, 4, 3)))
    assert np.abs(f).max() <= 1.0 and len(np.unique(f[:, 0])) == 8
    with pytest.raises(ValueError):
        q.clamped_nodes(n, "all")


@pytest.mark.parametrize("n", [4, 6])
def test_nnz_against_the_assembled_operator(n):
    """The chain's nonzeros are the assembled operator's pattern (the
    entries its element matrices write, some of which cancel to zero)
    among the free dofs, and the clamped dofs' diagonal: 994,881 at
    n=16, 15,553,785 at n=40, 26,877,153 at n=48."""
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    mesh = hex_mesh(n)
    ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
    ess[0] = 1
    A = assemble.build_discrete_problem(
        mesh, coef=q.coefficients(n, 2.0, 3), ess_attr_marker=ess,
        elasticity=True)[0]
    free = np.ones(A.shape[0], dtype=bool)
    free[assemble.ess_dofs_from_attrs(mesh, ess, 1, 3)] = False
    coo = A.tocoo()
    couplings = int((free[coo.row] & free[coo.col]).sum())
    assert couplings + int((~free).sum()) == elasticity_nnz(n)
    assert (elasticity_nnz(16), elasticity_nnz(40), elasticity_nnz(48)) == (
        994881, 15553785, 26877153)


def test_smooth_work_counts():
    nbytes, ops = elasticity_smooth_work(48, "float32", 10)
    assert nbytes == 26877153 * 4 + 4 * 3 * 49 ** 3 * 4
    assert ops == 2 * 26877153 * 11


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal(trace):
    """The cell reaches its comparison on the CPU, correct, reporting no
    device metric, and its program is the node-block one."""
    result = cells.run_cell(tiny_cell(), 2 ** 31 + 17, 0.3, bool(trace),
                            time.perf_counter(), device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["device"] == {"platform": "cpu"}
    if trace:
        assert set(result["metrics"]) == {"pcg.iters.elasticity"}
    else:
        assert set(result["metrics"]) == {"solve_ms.general", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, altered, not_converged])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    real = spec.load_module

    def load_module(kind, mod):
        m = real(kind, mod)
        if kind != "entries":
            return m

        class Broken:
            problem = staticmethod(m.problem)

            @staticmethod
            def compile(p, product, device):
                prog = m.compile(p, product, device)
                return dataclasses.replace(prog, solve=fault(prog.solve))
        return Broken

    monkeypatch.setattr(spec, "load_module", load_module)
    result = cells.run_cell(tiny_cell(), 2 ** 31 + 3, 0.2, False,
                            time.perf_counter(), device="cpu")
    assert not result["correct"] and result["failed"] >= 1
