"""Block-row device format for coarse Galerkin operators and tentative
restrictions.

Port of saamge_tpu/ops/blockrow.py.  Coarse dofs are numbered
MIS-contiguously, and all rows of one MIS share one column set, so each
row group is stored densely over its column union:

    x_g = x[col_union_g]          (one small gather per block row)
    y_g = Block_g @ x_g           (batched dense product)

Blocks are bucketed by padded (rows, cols) shape exactly as the JAX
module does (rows to multiples of 8, columns to multiples of 16).  The
products are plain torch (the JAX package uses einsum/take, no Pallas):
``matvec`` is a gather, a batched product and a gather; ``rmatvec``
ends in an ``index_add_``."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


class BlockRow(torch.nn.Module):
    """Bucket i holds buffers ``blocks{i}`` (B, r, c), ``colidx{i}``
    (B, c) with padding pointing at the zero slot m, and ``row0{i}``
    (B,) the first row of each block; ``gather_rows`` (n,) is the flat
    position of row i's value in the concatenated bucket outputs."""

    def __init__(self, buckets, gather_rows: torch.Tensor, shape):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.nbuckets = len(buckets)
        for i, (blocks, colidx, row0) in enumerate(buckets):
            self.register_buffer(f"blocks{i}", blocks)
            self.register_buffer(f"colidx{i}", colidx)
            self.register_buffer(f"row0{i}", row0)
        self.register_buffer("gather_rows", gather_rows)

    def buckets(self):
        for i in range(self.nbuckets):
            yield (getattr(self, f"blocks{i}"), getattr(self, f"colidx{i}"),
                   getattr(self, f"row0{i}"))

    @staticmethod
    def from_csr(A: sp.spmatrix, group_offsets: np.ndarray,
                 dtype=torch.float32) -> "BlockRow":
        """group_offsets: (G+1,) row-group boundaries (rows of one group
        are contiguous and share their column set by construction)."""
        A = A.tocsr()
        n, m = A.shape
        if group_offsets[0] != 0 or group_offsets[-1] != n:
            raise ValueError(f"group offsets span [{group_offsets[0]}, "
                             f"{group_offsets[-1]}], the matrix {n} rows")
        groups = {}
        for g in range(len(group_offsets) - 1):
            r0, r1 = int(group_offsets[g]), int(group_offsets[g + 1])
            if r1 == r0:
                continue
            sub = A[r0:r1]
            cols = np.unique(sub.indices)
            dense = np.asarray(sub[:, cols].todense())
            key = (-(-(r1 - r0) // 8) * 8, -(-max(len(cols), 1) // 16) * 16)
            groups.setdefault(key, []).append((r0, r1 - r0, cols, dense))
        buckets = []
        flat_pos = np.zeros(n, dtype=np.int64)
        flat_base = 0
        for (rpad, cpad), items in sorted(groups.items()):
            B = len(items)
            blocks = np.zeros((B, rpad, cpad))
            colidx = np.full((B, cpad), m, dtype=np.int64)   # zero slot
            row0 = np.zeros(B, dtype=np.int64)
            for k, (r0, nr, cols, dense) in enumerate(items):
                blocks[k, :nr, :len(cols)] = dense
                colidx[k, :len(cols)] = cols
                row0[k] = r0
                flat_pos[r0:r0 + nr] = flat_base + k * rpad + np.arange(nr)
            flat_base += B * rpad
            buckets.append((torch.as_tensor(blocks).to(dtype),
                            torch.as_tensor(colidx), torch.as_tensor(row0)))
        return BlockRow(buckets, torch.as_tensor(flat_pos), (n, m))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xp = torch.cat([x, x.new_zeros(1)])
        flat = torch.cat([torch.einsum("brc,bc->br", blocks, xp[colidx])
                          .reshape(-1)
                          for blocks, colidx, _ in self.buckets()])
        return flat[self.gather_rows]

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T y on the same storage: per block, gather the
        (contiguous) rows of y, contract with the transposed block and
        add into the column positions.  With MIS-blocked tentative
        restrictions this is the prolongator application (column sets
        partition the fine dofs, so the indices are unique)."""
        n, m = self.shape
        out = y.new_zeros(m + 1)                       # + zero slot
        yp = torch.cat([y, y.new_zeros(1)])
        for blocks, colidx, row0 in self.buckets():
            ridx = row0[:, None] + torch.arange(blocks.shape[1],
                                                device=y.device)[None, :]
            ridx = torch.where(ridx < n, ridx, n)      # pad rows -> 0
            xg = torch.einsum("brc,br->bc", blocks, yp[ridx])
            out.index_add_(0, colidx.reshape(-1), xg.reshape(-1))
        return out[:m]


class TransposedBlockRow(torch.nn.Module):
    """A^T view sharing the block storage (prolongator = restriction^T)."""

    def __init__(self, base: BlockRow):
        super().__init__()
        self.base = base

    @property
    def shape(self):
        n, m = self.base.shape
        return (m, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.rmatvec(x)
