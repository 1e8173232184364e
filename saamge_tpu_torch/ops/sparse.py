"""Row-aligned diagonal (DIA) storage of stencil operators.

Port of the DIA part of saamge_tpu/ops/sparse.py (DeviceDIA): the
values are row-aligned, ``vals[k, i] = A[i, i + offsets[k]]``, zero where
``i + offsets[k]`` leaves the matrix.  Vectors that kernels chain are
kept HALOED: ``halo = max|offset|`` zeros on each side of the ``n``
entries, so every tap is in bounds."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class DIA:
    vals: torch.Tensor          # (k, n)
    offsets: Tuple[int, ...]
    n: int

    @property
    def halo(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    @staticmethod
    def from_csr(A: sp.csr_matrix, dtype=torch.float32,
                 max_diags: int = 64) -> "DIA":
        """Raises if A is not square or has more than ``max_diags``
        distinct diagonals."""
        n, m = A.shape
        if n != m or n == 0:
            raise ValueError(f"DIA needs a square operator, got {A.shape}")
        A = A.tocsr()
        A.sum_duplicates()
        coo = A.tocoo()
        d = coo.col - coo.row
        offs = np.unique(d)
        if len(offs) > max_diags:
            raise ValueError(f"{len(offs)} diagonals > {max_diags}: not a "
                             "stencil operator")
        kidx = np.searchsorted(offs, d)
        vals = np.zeros((len(offs), n))
        vals[kidx, coo.row] = coo.data
        return DIA(torch.as_tensor(vals).to(dtype),
                   tuple(int(o) for o in offs), n)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """flat (n,) -> haloed (n + 2 halo,) f32."""
        return torch.nn.functional.pad(x.to(torch.float32),
                                       (self.halo, self.halo))

    def unpad(self, xh: torch.Tensor) -> torch.Tensor:
        return xh[self.halo:self.halo + self.n]


def dia_apply_h(A: DIA, xh: torch.Tensor) -> torch.Tensor:
    """(A x) on the n interior rows, from a haloed x (plain torch, any
    device); taps are summed in offset order in f32."""
    y = torch.zeros(A.n, dtype=torch.float32, device=xh.device)
    h = A.halo
    for k, off in enumerate(A.offsets):
        y += A.vals[k].to(torch.float32) * xh[h + off:h + off + A.n]
    return y


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A x on flat vectors (plain torch, any device)."""
    return dia_apply_h(A, A.pad(x))
