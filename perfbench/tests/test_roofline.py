"""The work count of the fine smoothing chain against hand counts."""

import numpy as np
import pytest

from perfbench.harness.roofline import (F32_FLOP_S, HBM_BYTES_S,
                                        fine_smooth_work, least_time_s,
                                        q1_nnz)


def test_nnz_by_hand():
    # n = 2: one interior node coupled to itself; 26 boundary diagonals
    assert q1_nnz(2) == 1 + 26
    # n = 3: 2^3 interior nodes all coupled (4 pairs a dimension), 56
    # boundary nodes
    assert q1_nnz(3) == 4 ** 3 + 56
    # n = 96: (3 * 95 - 2)^3 + 97^3 - 95^3
    assert q1_nnz(96) == 283 ** 3 + 97 ** 3 - 95 ** 3 == 22720485


def test_nnz_against_the_assembled_operator():
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    for n in (3, 5):
        mesh = hex_mesh(n)
        ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        A = assemble.build_discrete_problem(mesh, coef=1.0,
                                            ess_attr_marker=ess)[0]
        A.eliminate_zeros()
        assert A.nnz == q1_nnz(n)


def test_fine_smooth_work_tiny_level():
    # n = 2: 27 nnz, 27 nodes; 10 roots + residual
    nbytes, ops = fine_smooth_work(2, "bfloat16", 10)
    assert nbytes == 27 * 2 + 4 * 27 * 4
    assert ops == 2 * 27 * 11
    nbytes, ops = fine_smooth_work(2, "float32", 3, residual=False)
    assert nbytes == 27 * 4 + 3 * 27 * 4
    assert ops == 2 * 27 * 3


def test_least_time_names_its_bound():
    t, which = least_time_s(HBM_BYTES_S, 1.0)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = least_time_s(1.0, F32_FLOP_S * 2)
    assert which == "operations" and t == pytest.approx(2.0)
