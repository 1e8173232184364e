"""The work of the elasticity configuration's fine smoothing chain, whose
roofline the benchmark reads, counted from the problem's shapes and not
from the kernel that does the work; the peaks are those of
harness/roofline.py."""

from __future__ import annotations

from perfbench.harness.roofline import DTYPE_BYTES


def elasticity_nnz(n: int) -> int:
    """Nonzeros of the clamped Q1 elasticity operator on n^3 cubes (all
    three components clamped on the x = 0 face): the 3 x 3 couplings
    among the free nodes (x index 1 .. n), which couple to the 27
    neighbours they have, and one diagonal entry on each clamped dof."""
    pairs = (3 * n - 2) * (3 * n + 1) ** 2    # neighbour pairs of free nodes
    return 9 * pairs + 3 * (n + 1) ** 2


def elasticity_smooth_work(n: int, value_dtype: str, roots: int) -> tuple:
    """(bytes, float32 operations) of one fine smoothing chain: ``roots``
    root steps x += D^-1 (b - A x) / tau and the trailing residual.
    Bytes: the operator's nonzeros once in their stored dtype, b and x in,
    x and r out in float32 a dof.  Operations: 2 x nnz a step."""
    nnz = elasticity_nnz(n)
    ndof = 3 * (n + 1) ** 3
    nbytes = nnz * DTYPE_BYTES[value_dtype] + 4 * ndof * 4
    return nbytes, 2 * nnz * (roots + 1)
