"""Device sparse-matrix formats of the solve phase.

Port of saamge_tpu/ops/sparse.py:

  - DIA: row-aligned diagonals, ``vals[k, i] = A[i, i + offsets[k]]``,
    zero where ``i + offsets[k]`` leaves the matrix.  Vectors that
    kernels chain are kept HALOED: ``halo = max|offset|`` zeros on each
    side of the ``n`` entries, so every tap is in bounds.  The f32
    stencil passes are the hand-written kernels of ops/stencil.py and
    ops/smoother.py; ``dia_spmv`` is the plain product (any dtype).
  - ELL: rows padded to a common nnz/row; the product is a gather and a
    row sum.
  - Banded: dense band blocks of ``G`` rows applied to strided windows
    of x (``Tensor.unfold`` in place of JAX's
    ``conv_general_dilated_patches``).

ELL and Banded are ``nn.Module``s whose arrays are buffers, so
``.to(dev)`` moves them.  None of these products has a Pallas kernel in
the JAX package (it leaves them to XLA); they are plain torch here."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch


def _diagonals(A: sp.spmatrix):
    """(offsets, row-aligned (k, n) f64 values) of a square matrix."""
    A = A.tocsr()
    A.sum_duplicates()
    coo = A.tocoo()
    d = coo.col - coo.row
    offs = np.unique(d)
    # row-aligned storage built directly: vals[k, i] = A[i, i + off]
    kidx = np.searchsorted(offs, d)
    vals = np.zeros((len(offs), A.shape[0]))
    vals[kidx, coo.row] = coo.data
    return offs, vals


@dataclasses.dataclass
class DIA:
    vals: torch.Tensor          # (k, n)
    offsets: Tuple[int, ...]
    n: int

    @property
    def halo(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def try_from_csr(A: sp.spmatrix, dtype=torch.float32,
                     max_diags: int = 40) -> Optional["DIA"]:
        """None if A is not square or has more than ``max_diags``
        distinct diagonals (the JAX DeviceDIA.try_from_csr rule)."""
        n, m = A.shape
        if n != m or n == 0:
            return None
        offs, vals = _diagonals(A)
        if len(offs) > max_diags:
            return None
        return DIA(torch.as_tensor(vals).to(dtype),
                   tuple(int(o) for o in offs), n)

    @staticmethod
    def from_csr(A: sp.spmatrix, dtype=torch.float32,
                 max_diags: int = 64) -> "DIA":
        """Raises if A is not square or has more than ``max_diags``
        distinct diagonals."""
        dia = DIA.try_from_csr(A, dtype, max_diags)
        if dia is None:
            raise ValueError(f"DIA needs a square operator with at most "
                             f"{max_diags} diagonals, got {A.shape}")
        return dia

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """flat (n,) -> haloed (n + 2 halo,) f32."""
        return torch.nn.functional.pad(x.to(torch.float32),
                                       (self.halo, self.halo))

    def unpad(self, xh: torch.Tensor) -> torch.Tensor:
        return xh[self.halo:self.halo + self.n]


def dia_apply_h(A: DIA, xh: torch.Tensor) -> torch.Tensor:
    """(A x) on the n interior rows, from a haloed x (plain torch, any
    device); taps are summed in offset order, in f32 for f32 or bf16
    values and in f64 for f64 ones."""
    dt = torch.promote_types(torch.promote_types(A.vals.dtype, xh.dtype),
                             torch.float32)
    y = torch.zeros(A.n, dtype=dt, device=xh.device)
    h = A.halo
    for k, off in enumerate(A.offsets):
        y += A.vals[k].to(dt) * xh[h + off:h + off + A.n]
    return y


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A x on flat vectors (plain torch, any device and dtype)."""
    return dia_apply_h(A, torch.nn.functional.pad(x, (A.halo, A.halo)))


class ELL(torch.nn.Module):
    """Padded ELLPACK: cols (n, k) int64, vals (n, k).  Padding entries
    point at column 0 with value 0."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, shape):
        super().__init__()
        self.register_buffer("cols", cols)
        self.register_buffer("vals", vals)
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def from_csr(A: sp.spmatrix, dtype=torch.float32) -> "ELL":
        A = A.tocsr()
        A.sum_duplicates()
        n, m = A.shape
        row_nnz = np.diff(A.indptr)
        k = max(int(row_nnz.max()) if n else 0, 1)
        cols = np.zeros((n, k), dtype=np.int64)
        vals = np.zeros((n, k))
        rows = np.repeat(np.arange(n), row_nnz)
        pos = np.arange(len(A.data)) - np.repeat(A.indptr[:-1], row_nnz)
        cols[rows, pos] = A.indices
        vals[rows, pos] = A.data
        return ELL(torch.as_tensor(cols), torch.as_tensor(vals).to(dtype),
                   (n, m))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)


def ell_spmv(A: ELL, x: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k vals[i,k] * x[cols[i,k]]."""
    return (A.vals * x[A.cols]).sum(1)


class Banded(torch.nn.Module):
    """Dense band storage for square operators after an RCM reordering.

    Rows are processed in groups of G=8; row i reads x[i-lo : i+hi+1], so
    row group g reads the contiguous window x[g*G-lo : g*G+G-1+hi+1],
    which ``unfold`` cuts out as a strided view, contracted against the
    (RG, G, W) band blocks."""

    G = 8

    def __init__(self, blocks: torch.Tensor, lo: int, shape):
        super().__init__()
        self.register_buffer("blocks", blocks)
        self.lo = int(lo)
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def try_from_csr(A: sp.spmatrix, dtype=torch.float32,
                     max_fill: float = 8.0) -> Optional["Banded"]:
        A = A.tocsr()
        n, m = A.shape
        if n != m or n == 0:
            return None
        coo = A.tocoo()
        d = coo.col - coo.row
        lo, hi = (int(-d.min()), int(d.max())) if len(d) else (0, 0)
        G = Banded.G
        W = lo + hi + G
        RG = -(-n // G)
        if RG * G * W / max(A.nnz, 1) > max_fill:
            return None
        blocks = np.zeros((RG, G, W))
        g = coo.row // G
        # column offset inside the window starting at g*G - lo
        blocks[g, coo.row - g * G, coo.col - (g * G - lo)] = coo.data
        return Banded(torch.as_tensor(blocks).to(dtype), lo, (n, m))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return banded_spmv(self, x)


def banded_spmv(A: Banded, x: torch.Tensor) -> torch.Tensor:
    n = A.shape[0]
    RG, G, W = A.blocks.shape
    # pad so every window [g*G - lo, g*G - lo + W) is in range
    xp = torch.nn.functional.pad(x, (A.lo, RG * G + W - G - A.lo - n))
    patches = xp.unfold(0, W, G)                    # (RG, W) strided view
    y = torch.einsum("giw,gw->gi", A.blocks, patches)
    return y.reshape(-1)[:n]


DeviceMatrix = Union[DIA, ELL, Banded]


def device_matrix(A: sp.spmatrix, dtype=torch.float32,
                  prefer_dia: bool = True,
                  banded_max_fill: float = 8.0) -> DeviceMatrix:
    """Pick the device format as the JAX package does: structured DIA
    (stencils, <= 40 diagonals) > dense band (fill <= banded_max_fill) >
    padded ELL."""
    if prefer_dia:
        dia = DIA.try_from_csr(A, dtype)
        if dia is not None:
            return dia
        band = Banded.try_from_csr(A, dtype, banded_max_fill)
        if band is not None:
            return band
    return ELL.from_csr(A, dtype)


def rcm_permutation(A: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (band-minimizing)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(A.tocsr()), dtype=np.int64)
