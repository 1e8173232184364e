"""Interpolation data + the setup hot loop + prolongator smoothing.

Reference: interp.{hpp,cpp}.  interp_compute_vectors (interp.cpp:342) is the
setup hot loop: per AE assemble the local stiffness and solve the local
generalized eigenproblem.  On host it is a loop; the device path batches the
same math over padded AE stacks (saamge_tpu.ops.batched_eig).

interp_smooth (interp.cpp:172): P <- prod_k (I - (1/tau_k) D^{-1} A) P_tent
with tau_k the SA roots of degree nu_pro (interp_init_data, interp.cpp:231),
then drop-tolerance thresholding (AltThreshold, interp.cpp:134).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.setup.contrib import TentativeInterp, build_tentative
from saamge_tpu_torch.setup.spectral import Eigensolver
from saamge_tpu_torch.solve import smoothers
from saamge_tpu_torch.topology.agglomerate import AggPartRels
from saamge_tpu_torch.utils.logging import TIMERS, sa_assert, sa_print


@dataclasses.dataclass
class InterpData:
    """interp_data_t analog (interp.hpp:54-100)."""

    nparts: int
    nu_pro: int
    interp_smoother_roots: np.ndarray
    times_apply_smoother: int = 1
    drop_tol: float = 0.0
    use_truncated_eigensolver: bool = False
    # batch the per-AE eigensolves on device (ops.batched_eig) instead of
    # the host per-AE LAPACK loop
    use_batched_eigensolver: bool = False
    # MIS-SVD dedup tolerance (contrib.cpp:61 svd_eps=1e-10 for f64
    # LAPACK vectors); the device pipeline raises it to match the f32+
    # Rayleigh-Ritz eigenvector accuracy, else noise defeats the dedup
    svd_eps: float = 1e-10
    # device mesh for distributed setup: shards the per-AE eigensolve
    # batch and the per-MIS (owner-computes) SVD over the mesh
    # (parallel/dist_setup.py, SEC analog)
    setup_mesh: object = None
    # the device of the batched eigensolves: a card ("cuda", the
    # default) or "cpu" when the caller asks for it
    setup_device: object = "cuda"
    # AEs per eigensolver route of the batched path ("filter", "eigh",
    # "host", "host_resolve"), filled by compute_vectors
    eig_routes: Optional[dict] = None
    scaling_P: bool = False
    # per-AE caches
    cut_evects_arr: Optional[List[np.ndarray]] = None
    rhs_matrices_arr: Optional[List[np.ndarray]] = None   # B diagonals
    AEs_stiffm: Optional[List[np.ndarray]] = None
    # tentative-P products (filled by the tent assembly)
    tent: Optional[TentativeInterp] = None
    coarse_truedof_offset: int = 0
    # coarse-dof block offsets per MIS (aggregates.cpp:1693-1702)
    mis_coarsedofoffsets: Optional[np.ndarray] = None
    # adaptive-theta proposal: 0.5*theta + 0.5*mean(per-AE skipped
    # eigenvalue) (interp.cpp:571-589, eta=0.5)
    suggested_theta: Optional[float] = None

    @property
    def mis_numcoarsedof(self):
        return self.tent.mis_numcoarsedof if self.tent else None

    @property
    def mis_tent_interps(self):
        return self.tent.mis_tent_interps if self.tent else None


def interp_init_data(rels: AggPartRels, nu_pro: int,
                     use_truncated_eigensolver: bool = False,
                     scaling_P: bool = False) -> InterpData:
    """interp_init_data (interp.cpp:231): SA roots of degree nu_pro."""
    roots = smoothers.sa_poly_roots(nu_pro) if nu_pro > 0 else np.zeros(0)
    return InterpData(
        nparts=rels.nparts, nu_pro=nu_pro, interp_smoother_roots=roots,
        use_truncated_eigensolver=use_truncated_eigensolver,
        scaling_P=scaling_P,
        cut_evects_arr=[None] * rels.nparts,
        rhs_matrices_arr=[None] * rels.nparts,
        AEs_stiffm=[None] * rels.nparts)


def _suggest_theta(interp_data: InterpData, theta: float,
                   skipped) -> None:
    """interp.cpp:571-589: thetap = average skipped eigenvalue over
    agglomerates; suggestion = (1-eta) theta + eta thetap, eta=0.5."""
    sk = np.asarray([s for s in skipped if s is not None], dtype=np.float64)
    if len(sk):
        thetap = float(sk.mean())
        interp_data.suggested_theta = 0.5 * theta + 0.5 * thetap
        sa_print(5, "Suggested theta: %g (avg skipped %g, min %g)",
                 interp_data.suggested_theta, thetap, float(sk.min()))


def compute_vectors(rels: AggPartRels, interp_data: InterpData, elem_data,
                    theta: float, xbad: Optional[np.ndarray] = None,
                    transf: bool = False, readapting: bool = False,
                    tol: float = 0.0) -> bool:
    """interp_compute_vectors (interp.cpp:342) — the setup hot loop.

    Fills cut_evects_arr / rhs_matrices_arr / AEs_stiffm.  With ``transf``
    (adaptivity), the bad-guy vector xbad is orthogonalized against the old
    basis per AE and either triggers a subspace-enriched re-solve
    (spect_update) or is simply appended (readapting).  Returns whether any
    AE added a vector."""
    spect_update = not (transf and readapting)
    eig = Eigensolver(use_truncated=interp_data.use_truncated_eigensolver)
    vector_added = False
    if interp_data.use_batched_eigensolver and not transf:
        if interp_data.setup_mesh is not None:
            raise NotImplementedError(
                "a sharded setup mesh needs the distributed setup "
                "(ROADMAP Queue 1 item 9)")
        from saamge_tpu_torch._device import card_or_cpu
        device = card_or_cpu(interp_data.setup_device)
        routes = interp_data.eig_routes = {}
        # uniform-brick fast path: assembly + eigensolves entirely on
        # device (setup/device_setup.py); falls through when the
        # agglomeration is not translation invariant
        if not readapting:
            from saamge_tpu_torch.setup.device_setup import \
                uniform_spectral_cut
            with TIMERS.phase("setup.device_pipeline"):
                out = uniform_spectral_cut(
                    elem_data, theta,
                    use_truncated=interp_data.use_truncated_eigensolver,
                    device=device, routes=routes)
            if out is not None:
                cut, skipped, bdiags, aes = out
                interp_data.cut_evects_arr = cut
                interp_data.rhs_matrices_arr = bdiags
                _suggest_theta(interp_data, theta, skipped)
                interp_data.svd_eps = 1e-5
                if aes is not None:
                    interp_data.AEs_stiffm = aes
                return False
        # device path: one padded batched eigensolve per size bucket
        from saamge_tpu_torch.ops.batched_eig import batched_spectral_cut
        with TIMERS.phase("setup.ae_assembly"):
            if not readapting:
                interp_data.AEs_stiffm = elem_data.build_all_AE_stiff()
        with TIMERS.phase("setup.local_eigensolves"):
            cut, skipped, bdiags = batched_spectral_cut(
                interp_data.AEs_stiffm, theta,
                use_truncated=interp_data.use_truncated_eigensolver,
                device=device, routes=routes)
        interp_data.cut_evects_arr = cut
        interp_data.rhs_matrices_arr = bdiags
        _suggest_theta(interp_data, theta, skipped)
        sa_print(5, "eigensolver: %d batched device solves", rels.nparts)
        return False
    if not transf:
        # plain setup: CHUNKED assemble -> eigensolve -> sparsify
        # pipeline.  LAPACK releases the GIL, so the independent local
        # eigensolves run on a thread pool (the reference's per-AE loop
        # is serial per rank; SURVEY §2.2 item 5 makes this the
        # batching opportunity).  Dense per-AE stiffness blocks exist
        # only for the in-flight chunk: a 729-dof brick AE is 4.25 MB
        # dense but ~0.25 MB as CSR, and building ALL dense first
        # peaked 38 GB at 4.2M dofs (measured, --rss-trace) — the
        # retained cache (CoarseProvider local RAP, elmat.cpp:105-195,
        # + adaptivity re-solves) is sparse, matching the device
        # pipeline's want_sparse_aes (setup/device_setup.py:405).
        import concurrent.futures as cf
        import os
        nparts = rels.nparts
        interp_data.AEs_stiffm = [None] * nparts
        skipped_all = [None] * nparts
        workers = min(os.cpu_count() or 1, 16)
        chunk = max(workers, 64)

        def solve_one(A_T):
            return eig.solve(A_T, theta)

        with cf.ThreadPoolExecutor(workers) as ex:
            for lo in range(0, nparts, chunk):
                hi = min(lo + chunk, nparts)
                with TIMERS.phase("setup.ae_assembly"):
                    dense = [elem_data.build_AE_stiff(i)
                             for i in range(lo, hi)]
                with TIMERS.phase("setup.local_eigensolves"):
                    if hi - lo >= 8:
                        results = list(ex.map(solve_one, dense))
                    else:
                        results = [solve_one(a) for a in dense]
                with TIMERS.phase("setup.ae_sparsify"):
                    for k, (evects, skipped, B) in enumerate(results):
                        i = lo + k
                        interp_data.cut_evects_arr[i] = evects
                        interp_data.rhs_matrices_arr[i] = B
                        skipped_all[i] = skipped
                        A_T = dense[k]
                        if not sp.issparse(A_T):
                            A_sp = sp.csr_matrix(A_T)
                            if A_sp.data.nbytes * 1.5 < A_T.nbytes:
                                A_T = A_sp
                        interp_data.AEs_stiffm[i] = A_T
        _suggest_theta(interp_data, theta, skipped_all)
        sa_print(5, "eigensolver: %d solves (%d direct)",
                 eig.stats.count_solves, eig.stats.count_direct_solves)
        return False
    with TIMERS.phase("setup.local_eigensolves"):
        for i in range(rels.nparts):
            if not readapting:
                interp_data.AEs_stiffm[i] = elem_data.build_AE_stiff(i)
            A_T = interp_data.AEs_stiffm[i]
            if transf:
                xbad_AE = xbad[rels.AE_to_dof.row(i)]
                old = interp_data.cut_evects_arr[i]
                B = interp_data.rhs_matrices_arr[i]
                if spect_update:
                    # subspace: orthonormalize [old basis, xbad] in B inner
                    # product, re-solve in that subspace (interp.cpp:430-470
                    # + SolveDirect transf path, spectral.cpp:151-166)
                    Tt, added = _orthogonalize(xbad_AE, old, B, B, 1e-12)
                    evects, skipped, Bnew = _subspace_eigensolve(
                        eig, A_T, B, Tt, theta)
                    interp_data.cut_evects_arr[i] = evects
                    interp_data.rhs_matrices_arr[i] = Bnew
                    vector_added = vector_added or \
                        evects.shape[1] > old.shape[1]
                else:
                    # readapting: append xbad if energy-independent
                    denom = float(np.sqrt(xbad_AE @ (A_T @ xbad_AE)))
                    Tt, added = _orthogonalize(xbad_AE, old, B, A_T,
                                               tol * denom)
                    if added:
                        interp_data.cut_evects_arr[i] = Tt
                    vector_added = vector_added or added
            else:
                evects, skipped, B = eig.solve(A_T, theta)
                interp_data.cut_evects_arr[i] = evects
                interp_data.rhs_matrices_arr[i] = B
    sa_print(5, "eigensolver: %d solves (%d direct)",
             eig.stats.count_solves, eig.stats.count_direct_solves)
    return vector_added


def _orthogonalize(v: np.ndarray, basis: np.ndarray, Bip: np.ndarray,
                   Bnorm, ltol: float):
    """mbox_orthogonalize_sparse analog: Gram-Schmidt v against basis in the
    (diagonal) Bip inner product; append if the remainder's Bnorm-norm
    exceeds ltol.  Returns (new basis, appended?)."""
    w = v.copy()
    for j in range(basis.shape[1]):
        q = basis[:, j]
        w -= (float((Bip * q) @ w) / float((Bip * q) @ q)) * q
    if isinstance(Bnorm, np.ndarray) and Bnorm.ndim == 1:
        nrm = float(np.sqrt((Bnorm * w) @ w))
    else:
        nrm = float(np.sqrt(w @ (Bnorm @ w)))
    if nrm > ltol and nrm > 0.0:
        return np.concatenate([basis, (w / nrm)[:, None]], axis=1), True
    return basis.copy(), False


def _subspace_eigensolve(eig: Eigensolver, A_T: np.ndarray, B: np.ndarray,
                         Tt: np.ndarray, theta: float):
    """Transformed eigenproblem T A T^t y = lambda T B T^t y
    (SolveDirect transf path); eigenvectors mapped back by T^t."""
    Asub = Tt.T @ (A_T @ Tt)           # sparse-friendly order
    # columns of Tt are B-orthonormal, so the transformed B is the identity
    w, V = np.linalg.eigh(0.5 * (Asub + Asub.T))
    m = max(int(np.searchsorted(w, theta, side="right")), 1)
    Y = V[:, :m]
    return Tt @ Y, float(w[m] if m < len(w) else w[-1]), B


def sparse_tent_build(rels: AggPartRels, interp_data: InterpData, elem_data,
                      theta: float, avoid_ess_bdr_dofs: bool = True,
                      **compute_kwargs) -> sp.csr_matrix:
    """interp_sparse_tent_build (interp.cpp:694)."""
    compute_vectors(rels, interp_data, elem_data, theta, **compute_kwargs)
    return sparse_tent_assemble(rels, interp_data, avoid_ess_bdr_dofs)


def sparse_tent_assemble(rels: AggPartRels, interp_data: InterpData,
                         avoid_ess_bdr_dofs: bool = True,
                         extra_vectors=None,
                         use_spectral: bool = True) -> sp.csr_matrix:
    """interp_sparse_tent_assemble (interp.cpp:728)."""
    with TIMERS.phase("setup.mis_svd_tent"):
        svd_fn = None
        if interp_data.setup_mesh is not None:
            raise NotImplementedError(
                "a sharded setup mesh needs the distributed setup "
                "(ROADMAP Queue 1 item 9)")
        tent = build_tentative(
            rels,
            interp_data.cut_evects_arr if use_spectral else None,
            avoid_ess_bdr_dofs=avoid_ess_bdr_dofs,
            scaling_P=interp_data.scaling_P,
            extra_vectors=extra_vectors,
            svd_eps=interp_data.svd_eps,
            svd_fn=svd_fn)
    interp_data.tent = tent
    offsets = np.zeros(rels.num_mises + 1, dtype=np.int64)
    np.cumsum(tent.mis_numcoarsedof, out=offsets[1:])
    interp_data.mis_coarsedofoffsets = offsets
    # debug ladder: the spectral tentative P has orthonormal columns
    # (each MIS block is an SVD U factor; blocks have disjoint row
    # supports — interp.cpp:761's per-MIS insert), so P^T P = I.
    # scaling_P / non-spectral variants rescale columns and are exempt.
    if use_spectral and interp_data.scaling_P is None:
        sa_assert(7, lambda: abs((tent.P.T @ tent.P)
                                 - sp.identity(tent.P.shape[1])).max()
                  <= 1e-10, "tentative P columns not orthonormal")
    return tent.P


def interp_smooth(A: sp.csr_matrix, tent: sp.csr_matrix, dinv: np.ndarray,
                  roots: np.ndarray, times_apply: int = 1,
                  drop_tol: float = 0.0) -> sp.csr_matrix:
    """interp_smooth (interp.cpp:172): P = prod_k (I - (1/tau_k) D^{-1}A) P."""
    P = tent.tocsr()
    if len(roots) == 0:
        return P.copy()
    S = sp.diags(dinv) @ A          # D^{-1} A
    n = A.shape[0]
    I = sp.identity(n, format="csr")
    for tau in roots:
        M = (I - S / tau).tocsr()
        for _ in range(times_apply):
            P = (M @ P).tocsr()
    if drop_tol > 0.0:
        P.data[np.abs(P.data) <= drop_tol] = 0.0
        P.eliminate_zeros()
    return P
