"""The work of the full-capacity configuration's operations whose rooflines
the benchmark reads, counted from the problem's shapes and the setup's
operators, not from the kernels that do the work; the peaks are those of
harness/roofline.py."""

from __future__ import annotations

from perfbench.harness.roofline import DTYPE_BYTES, q1_nnz


def mfree_smooth_work(n: int, coef_dtype: str, roots: int) -> tuple:
    """(bytes, float32 operations) of one matrix-free fine smoothing chain:
    ``roots`` polynomial root steps and the trailing residual.  Bytes: the
    n^3 element coefficients once in their stored dtype, b and x in, x
    and r out in float32 a node.  Operations: 2 x nnz a step, the count
    of the stored operator's chain (roofline.fine_smooth_work)."""
    ndof = (n + 1) ** 3
    nbytes = n ** 3 * DTYPE_BYTES[coef_dtype] + 4 * ndof * 4
    ops = 2 * q1_nnz(n) * (roots + 1)
    return nbytes, ops


def mid_pass_work(nnz: int, n1: int, value_dtype: str) -> tuple:
    """(bytes, float32 operations) of one root pass x + dinv (b - A1 x) /
    tau of the level-1 operator with ``nnz`` nonzeros on ``n1`` dofs:
    its values once in their stored dtype, x, b and dinv in and x out in
    float32; 2 x nnz operations."""
    return nnz * DTYPE_BYTES[value_dtype] + 4 * n1 * 4, 2 * nnz
