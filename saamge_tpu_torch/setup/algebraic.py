"""Algebraic (matrix-only) interface.

Reference: tg.cpp:580-905 + fem.cpp:720-760.  Given only an assembled SPD
matrix: treat each DoF as a 'cell', partition the matrix graph into
agglomerates, extract AE matrices either as principal submatrices with
rowsum-zero diagonal compensation (ExtractSubMatrices, tg.cpp:580) or by
Henson-Vassilevski window AMG harmonic extension (WindowSubMatrices,
tg.cpp:741), then run the standard spectral pipeline.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.setup.elmat import ArrayProvider
from saamge_tpu_torch.setup.tg import TGData, tg_produce_data
from saamge_tpu_torch.topology.agglomerate import AggPartRels, \
    create_partitioning_fine
from saamge_tpu_torch.utils.tables import Table


def read_hypre_matrix(path: str) -> sp.csr_matrix:
    """ReadHypreMat (algebraic.cpp:63): '<r0> <r1> <c0> <c1>' header then
    'i j value' triplets (duplicates summed)."""
    with open(path) as f:
        header = f.readline().split()
        r0, r1, c0, c1 = (int(t) for t in header)
        ii, jj, vv = [], [], []
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            # subtract the base offsets so a nonzero-base slice (any
            # rank > 0 hypre dump) parses to its local shape instead of a
            # silently larger shifted matrix
            ii.append(int(parts[0]) - r0)
            jj.append(int(parts[1]) - c0)
            vv.append(float(parts[2]))
    return sp.coo_matrix(
        (vv, (ii, jj)), shape=(r1 - r0 + 1, c1 - c0 + 1)).tocsr()


def create_partitioning_from_matrix(A: sp.csr_matrix, nparts: int,
                                    isolated_cells=()) -> AggPartRels:
    """fem_create_partitioning_from_matrix (fem.cpp:720): elem == dof,
    elem_to_elem = graph of A, aggregates mode."""
    n = A.shape[0]
    # graph of A (excluding self loops for the partitioner; the reference's
    # TableFromSparseMatrix keeps the diagonal but METIS ignores it)
    coo = A.tocoo()
    off = coo.row != coo.col
    rows, cols = coo.row[off], coo.col[off]
    graph = Table.from_pairs(rows, cols, n, n)
    # edge weights = connection strength |a_ij|/sqrt(a_ii a_jj) so the
    # partitioner cuts weak couplings (aggregates align with anisotropy;
    # the same measure the Arbitrator uses, arbitrator.cpp:99).
    # NOTE: Table.from_pairs preserves within-row input order, so the
    # strengths computed in the same filtered order stay aligned with
    # graph.indices.
    diag = A.diagonal()
    strengths = np.abs(coo.data[off]) / np.sqrt(
        np.abs(diag[rows]) * np.abs(diag[cols]) + 1e-300)
    e2d = Table.identity(n)
    return create_partitioning_fine(A, e2d, graph, None, None, nparts,
                                    do_aggregates=True,
                                    edge_weights=strengths)


def extract_submatrices(A: sp.csr_matrix,
                        rels: AggPartRels) -> List[np.ndarray]:
    """ExtractSubMatrices (tg.cpp:580): principal submatrix per AE, then
    rowsum-zero diagonal compensation so constants are locally in the
    nullspace; pathological diagonals clamped to 1."""
    out = []
    n = A.shape[0]
    loc = np.full(n, -1, dtype=np.int64)
    for part in range(rels.nparts):
        dofs = rels.AE_to_dof.row(part)
        m = len(dofs)
        loc[dofs] = np.arange(m)
        M = np.zeros((m, m))
        rowsize = np.zeros(m, dtype=np.int64)
        for i, d in enumerate(dofs):
            lo, hi = A.indptr[d], A.indptr[d + 1]
            cols = A.indices[lo:hi]
            keep = np.isin(cols, dofs)
            # only structurally nonzero entries enter the submatrix
            vals = A.data[lo:hi][keep]
            nz = vals != 0.0
            M[i, loc[cols[keep]][nz]] = vals[nz]
            rowsize[i] = int(nz.sum())
        if m > 1:
            rowsums = M.sum(axis=1)
            multi = rowsize > 1
            M[np.arange(m)[multi], np.arange(m)[multi]] -= rowsums[multi]
            bad = np.diagonal(M) <= 0.0
            for i in np.nonzero(bad)[0]:
                M[i, i] = 1.0
        else:
            M[0, 0] = 1.0
        out.append(M)
    return out


def window_submatrices(A: sp.csr_matrix,
                       rels: AggPartRels) -> List[np.ndarray]:
    """WindowSubMatrices (tg.cpp:741): A_TT + A_TX E with E the row-scaled
    harmonic-like extension  E_{x,t} = a_{t,x} / sum_{s in T} a_{x,s}."""
    out = []
    n = A.shape[0]
    in_T = np.zeros(n, dtype=bool)
    loc = np.full(n, -1, dtype=np.int64)
    for part in range(rels.nparts):
        dofs = rels.AE_to_dof.row(part)
        m = len(dofs)
        if m == 1:
            out.append(np.ones((1, 1)))
            continue
        in_T[dofs] = True
        loc[dofs] = np.arange(m)
        # exterior neighbours X and their denominators
        xcol = {}
        denoms = []
        for d in dofs:
            lo, hi = A.indptr[d], A.indptr[d + 1]
            for c in A.indices[lo:hi]:
                if not in_T[c] and c not in xcol:
                    lo2, hi2 = A.indptr[c], A.indptr[c + 1]
                    cols2 = A.indices[lo2:hi2]
                    val = A.data[lo2:hi2][in_T[cols2]].sum()
                    assert abs(val) > 0.0
                    xcol[c] = len(denoms)
                    denoms.append(val)
        nx = len(denoms)
        ATT = np.zeros((m, m))
        ATX = np.zeros((m, nx))
        E = np.zeros((nx, m))
        for i, d in enumerate(dofs):
            lo, hi = A.indptr[d], A.indptr[d + 1]
            for c, v in zip(A.indices[lo:hi], A.data[lo:hi]):
                if in_T[c]:
                    ATT[i, loc[c]] += v
                else:
                    k = xcol[c]
                    ATX[i, k] += v
                    E[k, i] += v / denoms[k]
        out.append(ATT + ATX @ E)
        in_T[dofs] = False
    return out


def tg_produce_data_algebraic(A: sp.csr_matrix, rels: AggPartRels,
                              nu_pro: int, nu_relax: int,
                              spectral_tol: float, smooth_interp: bool,
                              polynomial_coarse: int = -1,
                              use_window: bool = False,
                              use_truncated_eigensolver: bool = True,
                              avoid_ess_bdr_dofs: bool = True) -> TGData:
    """tg_produce_data_algebraic (tg.cpp:862)."""
    if use_window:
        ae_mats = window_submatrices(A, rels)
    else:
        ae_mats = extract_submatrices(A, rels)
    emp = ArrayProvider(rels, ae_mats)
    return tg_produce_data(A, rels, nu_pro, nu_relax, emp, spectral_tol,
                           smooth_interp, polynomial_coarse,
                           use_truncated_eigensolver, avoid_ess_bdr_dofs)


def eliminate_dof0(A: sp.csr_matrix) -> sp.csr_matrix:
    """algebraic.cpp:226-243: drop row/col 0 (pure-Neumann fix)."""
    return A[1:, :][:, 1:].tocsr()
