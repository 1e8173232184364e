"""Boolean relation tables (CSR index graphs) on host.

Replacement for the reference's use of mfem::Table (elem_to_dof, AE_to_elem,
mis_to_dof, ... — aggregates.hpp:120-179).  A Table is an immutable CSR
pattern: ``indptr`` (n+1,) and ``indices`` (nnz,) numpy int arrays.

Column order within a row is semantically meaningful in a few places (it
defines the local DoF numbering inside an agglomerate), so ``mult`` keeps the
first-encounter order the reference's Table::Mult produces, and ``transpose``
is stable (row-major order of the source), matching mfem::Transpose.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def group_rows(sig: np.ndarray) -> tuple:
    """Group identical rows of a 2D int array: returns (inverse, num)
    with groups numbered in lexicographic row order — the same
    (inverse, len(uniq)) np.unique(sig, axis=0, return_inverse=True)
    yields, but via lexsort (ncol radix passes) + neighbor-diff instead
    of the void-dtype quicksort (~3x faster on AE-signature matrices)."""
    n = sig.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    if sig.shape[1] == 0:
        # width-0 signatures: every row is identical (np.unique(axis=0)
        # semantics); lexsort would reject an empty key sequence
        return np.zeros(n, dtype=np.int64), 1
    order = np.lexsort(sig.T[::-1])
    ss = sig[order]
    new = np.empty(n, dtype=bool)
    new[0] = True
    if n > 1:
        new[1:] = (ss[1:] != ss[:-1]).any(axis=1)
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = np.cumsum(new) - 1
    return inverse, int(new.sum())


@dataclasses.dataclass(frozen=True)
class Table:
    indptr: np.ndarray   # (nrows+1,) int64
    indices: np.ndarray  # (nnz,) int64
    ncols: int

    @property
    def nrows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def row_size(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    def row_sizes(self) -> np.ndarray:
        return np.diff(self.indptr)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_rows(rows, ncols: int) -> "Table":
        if isinstance(rows, np.ndarray) and rows.ndim == 2:
            # rectangular fast path (element connectivity arrays)
            n, k = rows.shape
            indptr = np.arange(0, (n + 1) * k, k, dtype=np.int64)
            return Table(indptr, rows.astype(np.int64).ravel(), ncols)
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        for i, r in enumerate(rows):
            indptr[i + 1] = indptr[i] + len(r)
        indices = (np.concatenate([np.asarray(r, dtype=np.int64) for r in rows])
                   if rows and indptr[-1] > 0 else np.zeros(0, dtype=np.int64))
        return Table(indptr, indices, ncols)

    @staticmethod
    def from_pairs(row_ids: np.ndarray, col_ids: np.ndarray, nrows: int,
                   ncols: int) -> "Table":
        """Build from (row, col) pairs; stable within-row order of the input."""
        row_ids = np.asarray(row_ids, dtype=np.int64)
        col_ids = np.asarray(col_ids, dtype=np.int64)
        counts = np.bincount(row_ids, minlength=nrows)
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # already grouped by row (Table.mult output, lexsorted pair lists):
        # skip the permutation entirely — the O(n) monotonicity scan is an
        # order of magnitude cheaper than the radix argsort it avoids
        if len(row_ids) == 0 or (np.diff(row_ids) >= 0).all():
            return Table(indptr, col_ids.copy(), ncols)
        order = np.argsort(row_ids, kind="stable")
        return Table(indptr, col_ids[order], ncols)

    @staticmethod
    def from_partition(partition: np.ndarray, nparts: int) -> "Table":
        """AE_to_elem from an element->AE assignment array.

        Mirrors agg_construct_tables_from_arr (aggregates.cpp): row p lists the
        elements assigned to part p, in increasing element order.
        """
        partition = np.asarray(partition, dtype=np.int64)
        elems = np.arange(len(partition), dtype=np.int64)
        return Table.from_pairs(partition, elems, nparts, len(partition))

    @staticmethod
    def identity(n: int) -> "Table":
        return Table(np.arange(n + 1, dtype=np.int64),
                     np.arange(n, dtype=np.int64), n)

    # -- algebra -----------------------------------------------------------

    def transpose(self) -> "Table":
        row_of = np.repeat(np.arange(self.nrows, dtype=np.int64),
                           self.row_sizes())
        return Table.from_pairs(self.indices, row_of, self.ncols, self.nrows)

    def mult(self, other: "Table") -> "Table":
        """Boolean product; within-row column order = first encounter
        (matches mfem::Mult(Table,Table) used throughout aggregates.cpp)."""
        assert self.ncols == other.nrows, (self.ncols, other.nrows)
        # Gather: for every (i, k) of self and (k, j) of other produce (i, j).
        mid = self.indices
        rsz = other.row_sizes()
        if len(rsz) and int(rsz.min()) == int(rsz.max()):
            # rectangular right factor (elem_to_dof): one 2D row gather
            # replaces the starts/offsets scatter machinery
            k = int(rsz[0])
            out_rows = np.repeat(np.repeat(
                np.arange(self.nrows, dtype=np.int64), self.row_sizes()), k)
            out_cols = other.indices.reshape(other.nrows, k)[mid].ravel()
        else:
            reps = rsz[mid]
            out_rows = np.repeat(
                np.repeat(np.arange(self.nrows, dtype=np.int64),
                          self.row_sizes()),
                reps)
            # concatenated columns of other's rows selected by mid, in order
            starts = other.indptr[mid]
            offsets = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps)
            out_cols = other.indices[np.repeat(starts, reps) + offsets]
        # dedupe per row, preserving first occurrence (stable radix
        # argsort + neighbor-diff: same result as np.unique(...,
        # return_index=True) but O(n) int sort instead of quicksort)
        key = out_rows * np.int64(other.ncols) + out_cols
        korder = np.argsort(key, kind="stable")
        ks = key[korder]
        keep = np.ones(len(ks), dtype=bool)
        if len(ks) > 1:
            keep[1:] = ks[1:] != ks[:-1]
        first_idx = korder[keep]
        first_idx.sort()
        return Table.from_pairs(out_rows[first_idx], out_cols[first_idx],
                                self.nrows, other.ncols)

    def to_csr(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (np.ones(self.nnz, dtype=np.int8), self.indices, self.indptr),
            shape=(self.nrows, self.ncols))

    def __eq__(self, other) -> bool:  # pragma: no cover - debugging helper
        return (isinstance(other, Table) and self.ncols == other.ncols
                and np.array_equal(self.indptr, other.indptr)
                and np.array_equal(self.indices, other.indices))
