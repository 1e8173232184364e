"""Published peaks of one NVIDIA H100 SXM and the work of the operations
whose rooflines the benchmark reads, counted from the problem's shapes and
not from the kernel that does the work."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet, 700 W)
F32_FLOP_S = 67e12          # H100 SXM float32 outside the tensor cores

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def q1_nnz(n: int) -> int:
    """Nonzeros of the Q1 operator on n^3 cubes after the boundary
    elimination: the 27-point couplings among interior nodes, and one
    diagonal entry on each boundary node."""
    m = n - 1                              # interior nodes a side
    interior = (3 * m - 2) ** 3 if m > 0 else 0
    return interior + (n + 1) ** 3 - max(m, 0) ** 3


def fine_smooth_work(n: int, value_dtype: str, roots: int,
                     residual: bool = True) -> tuple:
    """(bytes, float32 operations) of one fine smoothing chain: ``roots``
    polynomial root steps x += D^-1 (b - A x) / tau, then, with
    ``residual``, r = b - A x.  Bytes: the operator's values once in
    their stored dtype, b and x in, x (and r) out in float32.
    Operations: 2 x nnz a step."""
    nnz = q1_nnz(n)
    ndof = (n + 1) ** 3
    vectors = 3 + int(residual)
    nbytes = nnz * DTYPE_BYTES[value_dtype] + vectors * ndof * 4
    ops = 2 * nnz * (roots + int(residual))
    return nbytes, ops


def least_time_s(nbytes: float, ops: float) -> tuple:
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    tb, tf = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")
