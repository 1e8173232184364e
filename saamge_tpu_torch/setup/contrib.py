"""Tentative prolongator assembly over MISes.

Host path for ContribTent (contrib.cpp): restrict each containing AE's kept
eigenvectors to the MIS (CommunicateEigenvectors, contrib.cpp:492 — in the
sharded setting this is the owner-computes reduce; on one host it is a pure
gather), zero essential-boundary rows and drop all-zero columns
(contrib_filter_boundary, contrib.cpp:102), normalize the surviving columns,
SVD the concatenated block (xpack_svd_dense_arr, xpacks.cpp:494), keep left
singular vectors with sigma > svd_eps * sigma_max (xpack_orth_set,
xpacks.cpp:591, svd_eps = 1e-10), and insert the orthonormal block as the
MIS's columns of the tentative P (contrib_tent_insert_simple,
contrib.cpp:168).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.topology.agglomerate import AggPartRels
from saamge_tpu_torch.utils.logging import sa_print

SVD_EPS = 1e-10  # contrib.cpp:61


@dataclasses.dataclass
class TentativeInterp:
    """Outputs of the tentative-P build consumed by coarse levels
    (interp_data_t fields: mis_tent_interps, mis_numcoarsedof,
    local_coarse_one_representation, coarse_truedof_offset)."""

    P: sp.csr_matrix
    mis_tent_interps: List[np.ndarray]
    mis_numcoarsedof: np.ndarray
    local_coarse_one_representation: Optional[np.ndarray]
    coarse_truedof_offset: int = 0


def restrict_evects_to_mis(rels: AggPartRels, mis: int, ae: int,
                           cut_evects: np.ndarray) -> np.ndarray:
    """agg_restrict_to_agg_enforce (aggregates.cpp:1143): rows of the AE's
    eigenvector block at the MIS's dofs, in mis_to_dof row order."""
    mis_dofs = rels.mis_to_dof.row(mis)
    loc = rels.dofs_local_ids_in_AE(mis_dofs, ae)
    assert (loc >= 0).all()
    return cut_evects[loc, :]


def _filter_boundary(rels: AggPartRels, block: np.ndarray,
                     mis_dofs: np.ndarray,
                     avoid_ess_bdr_dofs: bool) -> np.ndarray:
    """contrib_filter_boundary: zero rows on essential boundary, drop columns
    that become entirely zero."""
    out = block.copy()
    if avoid_ess_bdr_dofs:
        ess = rels.is_dof_ess(mis_dofs)
        out[ess, :] = 0.0
    keep = np.abs(out).sum(axis=0) > 0.0
    return out[:, keep]


def _svd_orth(blocks: List[np.ndarray], eps: float = SVD_EPS) -> np.ndarray:
    """Column-normalize, concatenate, SVD, keep sigma > eps*sigma_max."""
    cols = []
    for b in blocks:
        for j in range(b.shape[1]):
            v = b[:, j]
            nrm = np.linalg.norm(v)
            if nrm > 0.0:
                cols.append(v / nrm)
    if not cols:
        return np.zeros((blocks[0].shape[0], 0))
    M = np.stack(cols, axis=1)
    U, s, _ = np.linalg.svd(M, full_matrices=False)
    if s.size == 0 or s[0] <= 0.0:
        return np.zeros((M.shape[0], 0))
    k = int((s > eps * s[0]).sum())  # count of sigma > eps*sigma_max
    return U[:, :k]


def _pad2(n: int, lo: int = 2) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def build_tentative(rels: AggPartRels,
                    cut_evects_arr: Optional[List[np.ndarray]],
                    avoid_ess_bdr_dofs: bool = True,
                    scaling_P: bool = False,
                    extra_vectors=None,
                    svd_eps: float = SVD_EPS,
                    svd_fn=None) -> TentativeInterp:
    """contrib_mises + SVDInsert (contrib.cpp:551-716), batched: per-MIS
    eigenvector blocks are gathered with one flat index computation, bucketed
    by padded (rows, cols) shape, and factored with ONE batched SVD per
    bucket (the per-MIS LAPACK loop of the reference becomes stacked
    gesdd calls; semantics identical — padding rows/cols are zero, so they
    add only zero singular values and zero rows in U).

    ``extra_vectors``: optional callable(mis, mis_dofs) -> block to append
    (polynomial/RBM enrichment, ExtendWith* in contrib.cpp:300-460)."""
    num_mises = rels.num_mises
    ND = rels.ND
    sizes = np.asarray(rels.mises_size, dtype=np.int64)
    m2d = rels.mis_to_dof
    ess_all = rels.is_dof_ess(m2d.indices)

    # per-MIS classification (order of checks matches the loop version)
    all_ess = np.ones(num_mises, dtype=bool)
    np.logical_and.at(all_ess, np.repeat(np.arange(num_mises),
                                         sizes), ess_all)
    zero_out = avoid_ess_bdr_dofs & all_ess          # contributes nothing
    trivial = (sizes == 1) & ~zero_out               # basis = [[1.0]]

    # spectral column counts per (mis, ae) pair
    pair_mis = np.repeat(np.arange(num_mises, dtype=np.int64),
                         rels.mis_to_AE.row_sizes())
    pair_ae = rels.mis_to_AE.indices
    if cut_evects_arr is not None:
        ae_cols = np.array([c.shape[1] for c in cut_evects_arr],
                           dtype=np.int64)
    else:
        ae_cols = np.zeros(rels.nparts, dtype=np.int64)
    pair_m = ae_cols[pair_ae]
    c_spec = np.zeros(num_mises, dtype=np.int64)
    np.add.at(c_spec, pair_mis, pair_m)

    # extra (polynomial/RBM) blocks, gathered per MIS (cheap host callables)
    extra_blocks: List[Optional[np.ndarray]] = [None] * num_mises
    c_extra = np.zeros(num_mises, dtype=np.int64)
    if extra_vectors is not None:
        for mis in range(num_mises):
            if zero_out[mis] or trivial[mis]:
                continue
            eb = extra_vectors(mis, m2d.row(mis))
            if eb is not None and eb.shape[1] > 0:
                extra_blocks[mis] = eb
                c_extra[mis] = eb.shape[1]
    c_m = c_spec + c_extra

    active = ~zero_out & ~trivial & (c_m > 0)
    silent_zero = ~zero_out & ~trivial & (c_m == 0)
    if silent_zero.any():
        sa_print(5, "WARNING: completely zero contribution on %d mises!",
                 int(silent_zero.sum()))

    mis_tent_interps: List[np.ndarray] = [
        np.zeros((int(sizes[m]), 0)) for m in range(num_mises)]
    mis_numcoarsedof = np.zeros(num_mises, dtype=np.int64)
    for m in np.flatnonzero(trivial):
        mis_tent_interps[m] = np.ones((1, 1))
        mis_numcoarsedof[m] = 1

    if active.any():
        _batched_svd_bases(rels, cut_evects_arr, extra_blocks, active,
                           sizes, c_m, pair_mis, pair_ae, pair_m,
                           avoid_ess_bdr_dofs, mis_tent_interps,
                           mis_numcoarsedof, svd_eps, svd_fn)

    # assemble P from the per-MIS bases (exact-zero entries dropped, as in
    # contrib_tent_insert_simple)
    offsets = np.zeros(num_mises + 1, dtype=np.int64)
    np.cumsum(mis_numcoarsedof, out=offsets[1:])
    filled_cols = int(offsets[-1])
    rows_idx, cols_idx, vals = [], [], []
    one_rep = [] if scaling_P else None
    for mis in range(num_mises):
        ncd = int(mis_numcoarsedof[mis])
        if ncd == 0:
            continue
        basis = mis_tent_interps[mis]
        mis_dofs = m2d.row(mis)
        nz = basis != 0.0
        r, c = np.nonzero(nz)
        rows_idx.append(mis_dofs[r])
        cols_idx.append(offsets[mis] + c)
        vals.append(basis[r, c])
        if scaling_P:
            # basis columns are orthonormal (SVD/U or [[1]]), so the
            # least-squares fit of ones is basis^T 1 (contrib.cpp:655-668)
            x = basis.sum(axis=0)
            nrm = np.linalg.norm(x)
            one_rep.extend((x / nrm if nrm > 0 else x).tolist())

    if rows_idx:
        P = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows_idx), np.concatenate(cols_idx))),
            shape=(ND, filled_cols)).tocsr()
    else:
        P = sp.csr_matrix((ND, 0))
    return TentativeInterp(
        P=P, mis_tent_interps=mis_tent_interps,
        mis_numcoarsedof=mis_numcoarsedof,
        local_coarse_one_representation=(
            np.asarray(one_rep) if scaling_P else None))


def _batched_svd_bases(rels, cut_evects_arr, extra_blocks, active, sizes,
                       c_m, pair_mis, pair_ae, pair_m, avoid_ess_bdr_dofs,
                       mis_tent_interps, mis_numcoarsedof,
                       svd_eps: float = SVD_EPS, svd_fn=None) -> None:
    """Fill mis_tent_interps/mis_numcoarsedof for the active MISes via
    bucketed batched SVD."""
    from saamge_tpu_torch.topology.agglomerate import _ranges, mis_ae_locs

    num_mises = rels.num_mises
    pair_indptr, locs = mis_ae_locs(rels)
    m2d = rels.mis_to_dof

    # bucket active MISes by padded (s, c)
    s_pad = np.array([_pad2(int(s)) for s in sizes], dtype=np.int64)
    c_pad = np.array([_pad2(int(c)) for c in c_m], dtype=np.int64)
    bkey = s_pad * np.int64(1 << 32) + c_pad
    act_idx = np.flatnonzero(active)
    buckets: dict = {}
    for m in act_idx:
        buckets.setdefault(int(bkey[m]), []).append(int(m))

    # flat concatenation of all eigenvector blocks for vectorized gathers
    if cut_evects_arr is not None:
        cut_off = np.zeros(rels.nparts + 1, dtype=np.int64)
        np.cumsum([c.size for c in cut_evects_arr], out=cut_off[1:])
        cut_flat = np.concatenate(
            [np.ascontiguousarray(c).ravel() for c in cut_evects_arr]) \
            if cut_off[-1] else np.zeros(0)
    else:
        cut_off = np.zeros(rels.nparts + 1, dtype=np.int64)
        cut_flat = np.zeros(0)

    # exclusive running column offset of each pair's block within its MIS
    coloff = np.zeros(len(pair_mis), dtype=np.int64)
    if len(pair_mis):
        cum = np.cumsum(pair_m) - pair_m
        mis_first = np.zeros(num_mises, dtype=np.int64)
        first_pos = np.searchsorted(pair_mis, np.arange(num_mises))
        mis_first = cum[np.clip(first_pos, 0, len(cum) - 1)] \
            if len(cum) else mis_first
        coloff = cum - mis_first[pair_mis]

    ess_flags = rels.is_dof_ess(m2d.indices)

    for _, mis_list in sorted(buckets.items()):
        mis_arr = np.asarray(mis_list, dtype=np.int64)
        B = len(mis_arr)
        sp_ = int(s_pad[mis_arr[0]])
        cp_ = int(c_pad[mis_arr[0]])
        M = np.zeros((B, sp_, cp_))
        item_of = np.full(num_mises, -1, dtype=np.int64)
        item_of[mis_arr] = np.arange(B)

        # vectorized spectral fill: one flat gather + one flat scatter
        psel = np.flatnonzero((item_of[pair_mis] >= 0) & (pair_m > 0))
        if len(psel):
            s_p = sizes[pair_mis[psel]]
            m_p = pair_m[psel]
            cnt = s_p * m_p
            ent_pair = np.repeat(psel, cnt)
            q = np.arange(int(cnt.sum()), dtype=np.int64) - \
                np.repeat(np.cumsum(cnt) - cnt, cnt)
            mp_e = pair_m[ent_pair]
            i_e = q // mp_e
            j_e = q - i_e * mp_e
            l_e = locs[pair_indptr[ent_pair] + i_e]
            src = cut_off[pair_ae[ent_pair]] + l_e * mp_e + j_e
            dst_item = item_of[pair_mis[ent_pair]]
            dst_col = coloff[ent_pair] + j_e
            M[dst_item, i_e, dst_col] = cut_flat[src]
        # extra blocks (per MIS; small)
        for m in mis_arr:
            eb = extra_blocks[m]
            if eb is not None:
                off = int(c_m[m] - eb.shape[1])
                M[int(item_of[m]), :eb.shape[0], off:off + eb.shape[1]] = eb

        # essential-boundary row filtering (contrib_filter_boundary)
        if avoid_ess_bdr_dofs:
            ii = _ranges(m2d.indptr[mis_arr], sizes[mis_arr])
            item_rep = np.repeat(np.arange(B), sizes[mis_arr])
            i_loc = np.arange(len(ii), dtype=np.int64) - np.repeat(
                np.cumsum(sizes[mis_arr]) - sizes[mis_arr], sizes[mis_arr])
            e = ess_flags[ii]
            M[item_rep[e], i_loc[e], :] = 0.0

        # column normalization (zero columns stay zero)
        nrm = np.linalg.norm(M, axis=1, keepdims=True)
        M = np.divide(M, np.where(nrm > 0.0, nrm, 1.0))

        if svd_fn is None:
            U, S, _ = np.linalg.svd(M, full_matrices=False)
        else:
            svd_eps = max(svd_eps, getattr(svd_fn, "suggested_eps", 0.0))
            # mesh-sharded batched SVD: each MIS's block is factored on
            # its owner shard (the SEC owner-computes analog,
            # contrib.cpp:492-549)
            U, S = svd_fn(M)
        s0 = S[:, :1]
        k_arr = ((S > svd_eps * s0) & (s0 > 0.0)).sum(axis=1)
        for b, m in enumerate(mis_arr):
            k = int(k_arr[b])
            n = int(sizes[m])
            if k == 0:
                sa_print(5, "WARNING: completely zero contribution on "
                            "mis %d!", int(m))
                continue
            mis_tent_interps[m] = np.ascontiguousarray(U[b, :n, :k])
            mis_numcoarsedof[m] = k


def build_tentative_loop(rels: AggPartRels,
                         cut_evects_arr: List[np.ndarray],
                         avoid_ess_bdr_dofs: bool = True,
                         scaling_P: bool = False,
                         extra_vectors=None) -> TentativeInterp:
    """Reference per-MIS loop implementation (kept as the semantic oracle
    for tests of the batched path above)."""
    num_mises = rels.num_mises
    ND = rels.ND
    mis_tent_interps: List[np.ndarray] = [None] * num_mises
    mis_numcoarsedof = np.zeros(num_mises, dtype=np.int64)
    one_rep = [] if scaling_P else None

    rows_idx, cols_idx, vals = [], [], []
    filled_cols = 0
    for mis in range(num_mises):
        mis_dofs = rels.mis_to_dof.row(mis)
        dim = len(mis_dofs)
        # gather restricted blocks from each containing AE
        blocks = []
        if cut_evects_arr is not None:
            for ae in rels.mis_to_AE.row(mis):
                blocks.append(restrict_evects_to_mis(
                    rels, mis, int(ae), cut_evects_arr[int(ae)]))
        if extra_vectors is not None:
            eb = extra_vectors(mis, mis_dofs)
            if eb is not None and eb.shape[1] > 0:
                blocks.append(eb)
        # all-essential MIS contributes nothing (SVDInsert, contrib.cpp:577)
        if avoid_ess_bdr_dofs and bool(rels.is_dof_ess(mis_dofs).all()):
            mis_numcoarsedof[mis] = 0
            mis_tent_interps[mis] = np.zeros((dim, 0))
            continue
        if dim == 1:
            basis = np.ones((1, 1))
        else:
            filtered = [_filter_boundary(rels, b, mis_dofs,
                                         avoid_ess_bdr_dofs) for b in blocks]
            basis = _svd_orth(filtered)
            if basis.shape[1] == 0:
                sa_print(5, "WARNING: completely zero contribution on "
                            "mis %d!", mis)
                mis_numcoarsedof[mis] = 0
                mis_tent_interps[mis] = np.zeros((dim, 0))
                continue
        mis_tent_interps[mis] = basis
        ncd = basis.shape[1]
        mis_numcoarsedof[mis] = ncd
        for j in range(ncd):
            nz = basis[:, j] != 0.0
            rows_idx.append(mis_dofs[nz])
            cols_idx.append(np.full(int(nz.sum()), filled_cols + j,
                                    dtype=np.int64))
            vals.append(basis[nz, j])
        if scaling_P and ncd > 0:
            x, *_ = np.linalg.lstsq(basis, np.ones(dim), rcond=None)
            nrm = np.linalg.norm(x)
            one_rep.extend((x / nrm).tolist())
        filled_cols += ncd

    if rows_idx:
        P = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows_idx), np.concatenate(cols_idx))),
            shape=(ND, filled_cols)).tocsr()
    else:
        P = sp.csr_matrix((ND, 0))
    return TentativeInterp(
        P=P, mis_tent_interps=mis_tent_interps,
        mis_numcoarsedof=mis_numcoarsedof,
        local_coarse_one_representation=(
            np.asarray(one_rep) if scaling_P else None))


# ---------------------------------------------------------------------------
# non-spectral / enrichment vector factories


def ones_vectors(rels: AggPartRels):
    """contrib_ones (contrib.cpp:474): one constant vector per MIS."""
    def make(mis, mis_dofs):
        return np.ones((len(mis_dofs), 1))
    return make


def linear_vectors(rels: AggPartRels, coords: np.ndarray):
    """contrib_linears (ExtendWithPolynomials order 1): constants + linears."""
    def make(mis, mis_dofs):
        c = coords[mis_dofs]   # (dim_mis, sdim)
        return np.concatenate([np.ones((len(mis_dofs), 1)), c], axis=1)
    return make


def rbm_vectors(rels: AggPartRels, coords: np.ndarray, sdim: int):
    """ExtendWithRBMs (contrib.cpp:353): rigid body modes for elasticity.

    DoF numbering is byVDIM (interleaved components); coords has one row per
    node.  Modes: translations per component + rotations."""
    def make(mis, mis_dofs):
        n = len(mis_dofs)
        nodes = mis_dofs // sdim
        comps = mis_dofs % sdim
        x = coords[nodes]     # (n, sdim)
        cols = []
        for d in range(sdim):
            t = np.zeros(n)
            t[comps == d] = 1.0
            cols.append(t)
        if sdim == 2:
            # rotation: u = (y, -x) (contrib.cpp:408-412)
            r = np.zeros(n)
            r[comps == 0] = x[comps == 0, 1]
            r[comps == 1] = -x[comps == 1, 0]
            cols.append(r)
        elif sdim == 3:
            # (y,-x,0), (0,z,-y), (-z,0,x) (contrib.cpp:414-436)
            r = np.zeros(n)
            r[comps == 0] = x[comps == 0, 1]
            r[comps == 1] = -x[comps == 1, 0]
            cols.append(r)
            r = np.zeros(n)
            r[comps == 1] = x[comps == 1, 2]
            r[comps == 2] = -x[comps == 2, 1]
            cols.append(r)
            r = np.zeros(n)
            r[comps == 0] = -x[comps == 0, 2]
            r[comps == 2] = x[comps == 2, 0]
            cols.append(r)
        return np.stack(cols, axis=1)
    return make
