"""Agglomeration topology: relation tables, MIS discovery, AE matrices.

Host-side equivalent of the reference's aggregates.{hpp,cpp}: the
``AggPartRels`` structure mirrors agg_partitioning_relations_t
(aggregates.hpp:120-179); MIS construction groups DoFs by identical
AE-membership signature (agg_construct_mises_local, aggregates.cpp:501-660);
the coarsest-level "aggregates" mode assigns contested DoFs by strongest
connection (agg_construct_aggregate_mises, aggregates.cpp:324 + Arbitrator,
arbitrator.cpp:99); AE stiffness extraction follows
agg_build_AE_stiffm_with_global (aggregates.cpp:855) and agg_build_AE_stiffm
(aggregates.cpp:959).

Everything here runs once per level on host and emits static index arrays;
the device solve path never touches these structures.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.topology.part import partition_kway
from saamge_tpu_torch.utils.logging import sa_assert, sa_print
from saamge_tpu_torch.utils.tables import Table, group_rows

# DoF status flags (aggregates.hpp agg_dof_status_t)
FLAG_ESS_BDR = 1 << 0      # AGG_ON_ESS_DOMAIN_BORDER_FLAG
FLAG_PROC_IFACE = 1 << 1   # AGG_ON_PROC_IFACE_FLAG
FLAG_OWNED = 1 << 2        # AGG_OWNED_FLAG
FLAG_BETWEEN_AES = 1 << 3  # AGG_BETWEEN_AES_FLAG


@dataclasses.dataclass
class AggPartRels:
    """Partitioning relations for one level (single-host numbering;
    truedof == dof)."""

    nparts: int
    ND: int
    partitioning: np.ndarray          # elem -> AE
    elem_to_dof: Table
    dof_to_elem: Table
    elem_to_elem: Table
    AE_to_elem: Table
    elem_to_AE: Table
    AE_to_dof: Table
    dof_to_AE: Table
    dof_id_inAE: np.ndarray           # aligned with dof_to_AE.indices
    agg_flags: np.ndarray             # (ND,) uint8
    # MIS structures
    num_mises: int = 0
    mises: Optional[np.ndarray] = None          # dof -> mis id
    mises_size: Optional[np.ndarray] = None
    mis_to_dof: Optional[Table] = None
    mis_to_AE: Optional[Table] = None
    AE_to_mis: Optional[Table] = None
    mis_master: Optional[np.ndarray] = None
    # coarse-level extras
    mis_coarsedofoffsets: Optional[np.ndarray] = None

    # -- queries ------------------------------------------------------------

    def dof_local_id_in_AE(self, dof: int, ae: int) -> int:
        """agg_map_id_glob_to_AE: local index of dof within AE's dof list."""
        return int(ae_local_ids(self, np.array([dof]), np.array([ae]))[0])

    def dofs_local_ids_in_AE(self, dofs: np.ndarray, ae: int) -> np.ndarray:
        dofs = np.asarray(dofs, dtype=np.int64)
        return ae_local_ids(self, dofs, np.full(len(dofs), ae,
                                                dtype=np.int64))

    def is_dof_ess(self, dofs) -> np.ndarray:
        return (self.agg_flags[dofs] & FLAG_ESS_BDR) != 0


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated [starts[i], starts[i]+lens[i]) ranges (vectorized)."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    idx = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    return np.repeat(np.asarray(starts, dtype=np.int64), lens) + idx


def _build_dof_id_inAE(AE_to_dof: Table, dof_to_AE: Table,
                       nparts: int) -> np.ndarray:
    """agg_build_glob_to_AE_id_map (aggregates.cpp:1202), vectorized:
    join the (dof, ae) pairs of dof_to_AE against AE_to_dof's entries
    (whose within-row position IS the local id) by sorted key."""
    rs = AE_to_dof.row_sizes()
    ae_of = np.repeat(np.arange(nparts, dtype=np.int64), rs)
    j_of = np.arange(AE_to_dof.nnz, dtype=np.int64) \
        - np.repeat(AE_to_dof.indptr[:-1], rs)
    key_a = AE_to_dof.indices * np.int64(nparts) + ae_of
    order = np.argsort(key_a, kind="stable")
    key_sorted = key_a[order]
    dof_of = np.repeat(np.arange(dof_to_AE.nrows, dtype=np.int64),
                       dof_to_AE.row_sizes())
    key_d = dof_of * np.int64(nparts) + dof_to_AE.indices
    pos = np.searchsorted(key_sorted, key_d)
    assert np.array_equal(key_sorted[pos], key_d)
    return j_of[order[pos]]


def ae_local_ids(rels: "AggPartRels", dofs: np.ndarray,
                 aes: np.ndarray) -> np.ndarray:
    """Vectorized agg_map_id_glob_to_AE for (dof, ae) pair arrays: the local
    index of each dof within its AE's dof list (-1 if not a member)."""
    join = getattr(rels, "_ae_join", None)
    if join is None:
        rs = rels.AE_to_dof.row_sizes()
        ae_of = np.repeat(np.arange(rels.nparts, dtype=np.int64), rs)
        j_of = np.arange(rels.AE_to_dof.nnz, dtype=np.int64) \
            - np.repeat(rels.AE_to_dof.indptr[:-1], rs)
        key = rels.AE_to_dof.indices * np.int64(rels.nparts) + ae_of
        order = np.argsort(key, kind="stable")
        join = (key[order], j_of[order])
        object.__setattr__(rels, "_ae_join", join)
    key_sorted, j_sorted = join
    q = np.asarray(dofs, dtype=np.int64) * np.int64(rels.nparts) \
        + np.asarray(aes, dtype=np.int64)
    pos = np.searchsorted(key_sorted, q).clip(0, len(key_sorted) - 1)
    out = np.where(key_sorted[pos] == q, j_sorted[pos], -1)
    return out


def mis_ae_locs(rels: "AggPartRels"):
    """For every entry p of mis_to_AE (a (mis, ae) pair): the local ids
    within the AE of the MIS's dofs (in mis_to_dof row order), concatenated.
    Returns (pair_indptr, locs); cached on rels.

    This is the vectorized core of agg_restrict_to_agg_enforce
    (aggregates.cpp:1143) shared by the tentative-P build and the coarse
    element-matrix provider."""
    cached = getattr(rels, "_mis_ae_locs", None)
    if cached is not None:
        return cached
    pair_mis = np.repeat(np.arange(rels.num_mises, dtype=np.int64),
                         rels.mis_to_AE.row_sizes())
    pair_ae = rels.mis_to_AE.indices
    s = rels.mises_size[pair_mis]
    pair_indptr = np.zeros(len(pair_mis) + 1, dtype=np.int64)
    np.cumsum(s, out=pair_indptr[1:])
    dofs = rels.mis_to_dof.indices[_ranges(rels.mis_to_dof.indptr[pair_mis],
                                           s)]
    aes = np.repeat(pair_ae, s)
    locs = ae_local_ids(rels, dofs, aes)
    assert (locs >= 0).all()
    out = (pair_indptr, locs)
    object.__setattr__(rels, "_mis_ae_locs", out)
    return out


def _construct_mises_local(rels: AggPartRels) -> None:
    """Group DoFs by identical AE-membership signature
    (agg_construct_mises_local, aggregates.cpp:501), vectorized: pad each
    dof's AE list (already in increasing AE order — dof_to_AE is the stable
    transpose of AE-major AE_to_dof) into a signature matrix and group rows
    with one lexsort pass (tables.group_rows).

    MIS ids are assigned in order of the lowest-numbered unvisited dof;
    within each MIS, dofs are sorted by (true)dof id — the determinism
    contract SortByTrueDof establishes (aggregates.cpp:271)."""
    ND = rels.ND
    d2ae = rels.dof_to_AE
    sizes = d2ae.row_sizes()
    maxm = int(sizes.max()) if ND else 1
    sig = np.full((ND, maxm), -1, dtype=np.int64)
    rows_idx = np.repeat(np.arange(ND, dtype=np.int64), sizes)
    cols_idx = np.arange(d2ae.nnz, dtype=np.int64) \
        - np.repeat(d2ae.indptr[:-1], sizes)
    sig[rows_idx, cols_idx] = d2ae.indices
    inverse, num = group_rows(sig)
    # renumber groups by their lowest-numbered dof (first-encounter order)
    first_dof = np.full(num, ND, dtype=np.int64)
    np.minimum.at(first_dof, inverse, np.arange(ND, dtype=np.int64))
    rank = np.empty(num, dtype=np.int64)
    rank[np.argsort(first_dof, kind="stable")] = np.arange(num)
    mises = rank[inverse]
    rels.num_mises = num
    rels.mises = mises
    rels.mis_to_dof = Table.from_pairs(mises, np.arange(ND, dtype=np.int64),
                                       num, ND)
    rels.mises_size = rels.mis_to_dof.row_sizes()
    rels.mis_master = np.zeros(rels.num_mises, dtype=np.int64)
    rels.mis_to_AE = rels.mis_to_dof.mult(rels.dof_to_AE)
    rels.AE_to_mis = rels.mis_to_AE.transpose()


def _arbitrate_aggregates(rels: AggPartRels, A: sp.csr_matrix) -> None:
    """Coarsest-level 'aggregates' mode: one disjoint aggregate per AE
    (agg_construct_aggregate_mises + Arbitrator.suggest)."""
    ND = rels.ND
    nparts = rels.nparts
    mises = np.full(ND, -2, dtype=np.int64)
    sizes = np.zeros(nparts, dtype=np.int64)
    for dof in range(ND):
        if rels.dof_to_AE.row_size(dof) == 1:
            p = int(rels.dof_to_AE.row(dof)[0])
            mises[dof] = p
            sizes[p] += 1
        else:
            rels.agg_flags[dof] |= FLAG_BETWEEN_AES
    diag = A.diagonal()
    for dof in range(ND):
        if mises[dof] != -2:
            continue
        # strongest connection among already-assigned neighbors whose
        # aggregate is an AE containing dof (arbitrator.cpp:99-160)
        lo, hi = A.indptr[dof], A.indptr[dof + 1]
        neighs = A.indices[lo:hi]
        vals = A.data[lo:hi]
        my_aes = set(int(a) for a in rels.dof_to_AE.row(dof))
        best, best_s = -1, -1.0
        for nb, v in zip(neighs, vals):
            if nb == dof:
                continue
            agg = mises[nb]
            if agg >= 0 and int(agg) in my_aes:
                s = abs(v) / np.sqrt(diag[dof] * diag[nb])
                if s > best_s:
                    best_s = s
                    best = int(agg)
        if best < 0:
            # fall back: smallest containing aggregate
            parts = rels.dof_to_AE.row(dof)
            best = int(parts[np.argmin(sizes[parts])])
        mises[dof] = best
        sizes[best] += 1
    rels.num_mises = nparts
    rels.mises = mises
    rels.mises_size = sizes
    rows = [[] for _ in range(nparts)]
    for dof in range(ND):
        rows[mises[dof]].append(dof)
    rels.mis_to_dof = Table.from_rows(rows, ND)
    rels.mis_master = np.zeros(nparts, dtype=np.int64)
    rels.mis_to_AE = Table.identity(nparts)
    rels.AE_to_mis = Table.identity(nparts)


def _finish_flags(rels: AggPartRels,
                  bdr_flags: Optional[np.ndarray]) -> None:
    """agg_construct_agg_flags (aggregates.cpp:198)."""
    flags = np.zeros(rels.ND, dtype=np.uint8) if bdr_flags is None \
        else np.asarray(bdr_flags, dtype=np.uint8).copy()
    between = rels.dof_to_AE.row_sizes() > 1
    between |= (flags & FLAG_PROC_IFACE) != 0
    flags[between] |= FLAG_BETWEEN_AES
    rels.agg_flags = flags


def create_partitioning_fine(
        A: sp.csr_matrix, elem_to_dof: Table, elem_to_elem: Table,
        partitioning: Optional[np.ndarray], bdr_flags: Optional[np.ndarray],
        nparts: int, do_aggregates: bool = False,
        part_seed: int = 0,
        edge_weights: Optional[np.ndarray] = None) -> AggPartRels:
    """agg_create_partitioning_fine (aggregates.cpp:1317)."""
    NE = elem_to_dof.nrows
    if partitioning is None:
        partitioning = partition_kway(elem_to_elem, None, nparts,
                                      seed=part_seed, adjwgt=edge_weights)
        nparts = int(partitioning.max()) + 1
    else:
        partitioning = np.asarray(partitioning, dtype=np.int64)
        nparts = int(partitioning.max()) + 1
    return _create_tables(A, elem_to_dof, elem_to_elem, partitioning,
                          bdr_flags, nparts, do_aggregates)


def _create_tables(A, elem_to_dof, elem_to_elem, partitioning, bdr_flags,
                   nparts, do_aggregates) -> AggPartRels:
    dof_to_elem = elem_to_dof.transpose()
    ND = dof_to_elem.nrows
    AE_to_elem = Table.from_partition(partitioning, nparts)
    elem_to_AE = AE_to_elem.transpose()
    AE_to_dof = AE_to_elem.mult(elem_to_dof)
    dof_to_AE = AE_to_dof.transpose()
    dof_id_inAE = _build_dof_id_inAE(AE_to_dof, dof_to_AE, nparts)
    rels = AggPartRels(
        nparts=nparts, ND=ND, partitioning=partitioning,
        elem_to_dof=elem_to_dof, dof_to_elem=dof_to_elem,
        elem_to_elem=elem_to_elem, AE_to_elem=AE_to_elem,
        elem_to_AE=elem_to_AE, AE_to_dof=AE_to_dof, dof_to_AE=dof_to_AE,
        dof_id_inAE=dof_id_inAE,
        agg_flags=np.zeros(ND, dtype=np.uint8))
    if do_aggregates:
        # aggregates mode sets BETWEEN_AES itself, then arbitrates
        if bdr_flags is not None:
            rels.agg_flags = np.asarray(bdr_flags, dtype=np.uint8).copy()
        _arbitrate_aggregates(rels, A)
    else:
        _construct_mises_local(rels)
        _finish_flags(rels, bdr_flags)
    sa_print(5, "Total number of MISes = %d", rels.num_mises)
    # debug ladder (O(N) structural invariants, aggregates.cpp's
    # SA_ASSERT family around agg_construct_mises): MISes partition the
    # dofs exactly, and each MIS is contained in every AE of its dofs
    sa_assert(6, lambda: (len(rels.mis_to_dof.indices) == ND
                          and len(np.unique(rels.mis_to_dof.indices)) == ND),
              "MISes do not partition the dof set")
    sa_assert(6, lambda: bool((rels.mises_size > 0).all()),
              "empty MIS produced")
    return rels


# ---------------------------------------------------------------------------
# AE stiffness matrices


def build_AE_stiffm_with_global(A: sp.csr_matrix, part: int,
                                rels: AggPartRels,
                                elem_mats: np.ndarray,
                                bdr_cond_imposed: bool = True,
                                assemble_ess_diag: bool = True) -> np.ndarray:
    """agg_build_AE_stiffm_with_global (aggregates.cpp:855), dense output.

    Entries where both DoFs are shared between AEs are re-assembled from the
    element matrices of elements inside this AE (Neumann-like interface
    values); all other entries are copied from the (BC-eliminated) global
    matrix.  For essential-boundary DoFs the global values are kept except
    the diagonal, which is re-assembled when ``assemble_ess_diag``."""
    dofs = rels.AE_to_dof.row(part)
    n = len(dofs)
    loc_of = _loc_scratch(rels)
    loc_of[dofs] = np.arange(n)
    # local re-assembly over elements of this AE (bincount fast path for
    # rectangular dense element batches; general loop otherwise)
    e2d = rels.elem_to_dof
    elems = rels.AE_to_elem.row(part)
    e2d_rect = getattr(rels, "_e2d_rect", None)
    if e2d_rect is None:
        e2d_rect = _rect(e2d)
        object.__setattr__(rels, "_e2d_rect", e2d_rect)
    # ndarray batches AND lazy factorized batches (FactorizedElemMats
    # duck-types ndim/shape/fancy-indexing) take the bincount fast path
    if getattr(elem_mats, "ndim", 0) == 3 and not callable(elem_mats) \
            and e2d_rect:
        nd = elem_mats.shape[1]
        loc = loc_of[e2d.indices.reshape(-1, nd)[elems]]
        flat = (loc[:, :, None] * n + loc[:, None, :]).ravel()
        A_loc = np.bincount(flat, weights=elem_mats[elems].ravel(),
                            minlength=n * n).reshape(n, n)
    else:
        A_loc = np.zeros((n, n))
        for e in elems:
            edofs = e2d.row(e)
            loc = loc_of[edofs]
            A_loc[np.ix_(loc, loc)] += elem_mats[e]
    # global submatrix values + pattern (incl. stored zeros: the reference
    # iterates the assembled CSR pattern, which keeps eliminated entries).
    # The membership mask is a reusable ND scratch (allocating per AE would
    # cost O(nparts * ND)).
    A_sub = np.zeros((n, n))
    in_pattern = np.zeros((n, n), dtype=bool)
    in_ae = getattr(rels, "_in_ae_scratch", None)
    if in_ae is None:
        in_ae = np.zeros(rels.ND, dtype=bool)
        object.__setattr__(rels, "_in_ae_scratch", in_ae)
    in_ae[dofs] = True
    rows_lo = A.indptr[dofs]
    rows_hi = A.indptr[dofs + 1]
    sel = _ranges(rows_lo, rows_hi - rows_lo)
    all_cols = A.indices[sel]
    all_vals = A.data[sel]
    all_rows = np.repeat(np.arange(n), rows_hi - rows_lo)
    keep = in_ae[all_cols]
    li = all_rows[keep]
    lc = loc_of[all_cols[keep]]
    A_sub[li, lc] = all_vals[keep]
    in_pattern[li, lc] = True
    in_ae[dofs] = False                      # reset scratch

    between = (rels.agg_flags[dofs] & FLAG_BETWEEN_AES) != 0
    ess = (rels.agg_flags[dofs] & FLAG_ESS_BDR) != 0
    both_between = np.outer(between, between)
    either_ess = np.outer(ess, np.ones(n, bool)) | \
        np.outer(np.ones(n, bool), ess)
    is_diag = np.eye(n, dtype=bool)
    suppress = bdr_cond_imposed & either_ess & \
        ~(assemble_ess_diag & is_diag)
    recompute = both_between & ~suppress & in_pattern
    out = np.where(recompute, A_loc, A_sub)
    return out


def build_AE_stiffm_all(A: sp.csr_matrix, rels: AggPartRels,
                        elem_mats: np.ndarray,
                        bdr_cond_imposed: bool = True,
                        assemble_ess_diag: bool = True) -> List[np.ndarray]:
    """All AE stiffness matrices.  Deliberately a per-AE loop: each AE's
    working set (a few-hundred-row dense block plus its CSR rows) is
    cache-resident, which on this memory-latency-bound host beats global
    vectorized joins whose multi-MB lookup tables thrash (measured 1.2s vs
    13-37s at 68921 dofs).  The per-AE body itself is fully vectorized."""
    return [build_AE_stiffm_with_global(A, p, rels, elem_mats,
                                        bdr_cond_imposed,
                                        assemble_ess_diag)
            for p in range(rels.nparts)]


# Above this size AE stiffness matrices are kept SPARSE and eigensolves go
# through the sparse truncated (LOBPCG) path — the analog of the reference
# solving large agglomerates with ARPACK on sparse AE matrices
# (agg_build_AE_stiffm returns SparseMatrix; arpacks.cpp:220).  Dense storage
# and eigh stay for small AEs where they are faster.
DENSE_AE_LIMIT = 768


def build_AE_stiffm_local(part: int, rels: AggPartRels,
                          elem_mats, sparse_out: Optional[bool] = None):
    """agg_build_AE_stiffm (aggregates.cpp:959): pure local assembly from
    per-element matrices (dense or per-element dense arrays/callables).
    Returns dense for small AEs, CSR above DENSE_AE_LIMIT (or as forced by
    ``sparse_out``)."""
    dofs = rels.AE_to_dof.row(part)
    n = len(dofs)
    loc_of = _loc_scratch(rels)
    loc_of[dofs] = np.arange(n)
    if sparse_out is None:
        sparse_out = n > DENSE_AE_LIMIT
    rr, cc, vv = [], [], []
    for e in rels.AE_to_elem.row(part):
        edofs = rels.elem_to_dof.row(e)
        loc = loc_of[edofs]
        em = elem_mats(e) if callable(elem_mats) else elem_mats[e]
        if sp.issparse(em):
            em = np.asarray(em.todense())
        m = len(loc)
        rr.append(np.repeat(loc, m))
        cc.append(np.tile(loc, m))
        vv.append(np.asarray(em, dtype=np.float64).ravel())
    if not rr:
        return sp.csr_matrix((n, n)) if sparse_out else np.zeros((n, n))
    rows = np.concatenate(rr)
    cols = np.concatenate(cc)
    vals = np.concatenate(vv)
    if sparse_out:
        return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return np.bincount(rows * n + cols, weights=vals,
                       minlength=n * n).reshape(n, n)


def _loc_scratch(rels: AggPartRels) -> np.ndarray:
    """Reusable ND-sized global->AE-local index scratch buffer."""
    buf = getattr(rels, "_loc_scratch_buf", None)
    if buf is None:
        buf = np.full(rels.ND, -1, dtype=np.int64)
        object.__setattr__(rels, "_loc_scratch_buf", buf)
    return buf


def _rect(t: Table) -> bool:
    rs = t.row_sizes()
    return len(rs) > 0 and (rs == rs[0]).all()


# ---------------------------------------------------------------------------
# coarse level


def create_partitioning_coarse(
        A_coarse: sp.csr_matrix,
        fine: AggPartRels,
        mis_numcoarsedof: np.ndarray,
        tent_interp: sp.csr_matrix,
        nparts: int,
        do_aggregates: bool = False,
        partitioning: Optional[np.ndarray] = None,
        part_seed: int = 0) -> AggPartRels:
    """agg_create_partitioning_coarse (aggregates.cpp:1736).

    Coarse 'element' = fine AE.  finedof_to_dof is the sparsity of the
    tentative prolongator; coarse elem_to_dof = fine AE_to_dof x
    finedof_to_dof; the coarse dual graph is AE_to_elem*e2e*elem_to_AE; the
    re-partition is weighted by AE DoF counts."""
    ND_coarse = tent_interp.shape[1]
    # mis_coarsedofoffsets (coarse dofs numbered by MIS blocks,
    # aggregates.cpp:1693-1702)
    offsets = np.zeros(fine.num_mises + 1, dtype=np.int64)
    np.cumsum(mis_numcoarsedof, out=offsets[1:])

    finedof_to_dof = _csr_to_table(tent_interp)
    elem_to_dof = fine.AE_to_dof.mult(finedof_to_dof)
    # coarse dual graph (self loops removed for the partitioner)
    e2e = fine.AE_to_elem.mult(fine.elem_to_elem).mult(fine.elem_to_AE)
    if partitioning is None:
        weights = fine.AE_to_dof.row_sizes().astype(np.float64)
        partitioning = partition_kway(_strip_diagonal(e2e), weights, nparts,
                                      seed=part_seed)
    partitioning = np.asarray(partitioning, dtype=np.int64)
    nparts = int(partitioning.max()) + 1
    rels = _create_tables(A_coarse, elem_to_dof, e2e, partitioning, None,
                          nparts, do_aggregates)
    rels.mis_coarsedofoffsets = None  # belongs to *this* level's fine MISes
    assert rels.ND == ND_coarse, (rels.ND, ND_coarse)
    return rels, offsets


def _csr_to_table(A: sp.csr_matrix) -> Table:
    A = A.tocsr()
    return Table(A.indptr.astype(np.int64), A.indices.astype(np.int64),
                 A.shape[1])


def _strip_diagonal(t: Table) -> Table:
    rows = [t.row(i)[t.row(i) != i] for i in range(t.nrows)]
    return Table.from_rows(rows, t.ncols)
