"""Element-matrix providers (elmat.{hpp,cpp} analog).

A provider supplies (a) per-element matrices and (b) assembled AE stiffness
matrices.  Three kinds mirror the reference:

  - GeometricProvider: finest level; element matrices from FEM assembly, AE
    stiffness by global-matrix extraction with interface re-assembly
    (ElementMatrixStandardGeometric, elmat.cpp:43-89).
  - CoarseProvider: coarse levels; the coarse element matrix for AE ``elno``
    is the local RAP of the finer AE stiffness with the AE-local tentative
    interpolator stitched from the finer level's per-MIS tent interps
    (ElementMatrixParallelCoarse, elmat.cpp:105-195).
  - ArrayProvider: AE matrices given directly (algebraic interface,
    ElementMatrixArray, elmat.cpp:197-225).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.topology.agglomerate import (
    AggPartRels, build_AE_stiffm_all, build_AE_stiffm_local,
    build_AE_stiffm_with_global)


class ElementMatrixProvider:
    is_geometric = False
    rels: AggPartRels

    def build_AE_stiff(self, part: int) -> np.ndarray:
        raise NotImplementedError

    def build_all_AE_stiff(self) -> List[np.ndarray]:
        """All AE stiffness matrices; providers override with batched
        builds where the per-AE loop is the setup bottleneck."""
        return [self.build_AE_stiff(p) for p in range(self.rels.nparts)]

    def get_elem_matrix(self, elno: int) -> np.ndarray:
        raise NotImplementedError


class GeometricProvider(ElementMatrixProvider):
    is_geometric = True

    def __init__(self, rels: AggPartRels, A: sp.csr_matrix,
                 elem_mats: np.ndarray, bdr_cond_imposed: bool = True,
                 assemble_ess_diag: bool = True):
        self.rels = rels
        self.A = A
        self.elem_mats = elem_mats
        self.bdr_cond_imposed = bdr_cond_imposed
        self.assemble_ess_diag = assemble_ess_diag

    def build_AE_stiff(self, part: int) -> np.ndarray:
        return build_AE_stiffm_with_global(
            self.A, part, self.rels, self.elem_mats,
            self.bdr_cond_imposed, self.assemble_ess_diag)

    def build_all_AE_stiff(self) -> List[np.ndarray]:
        return build_AE_stiffm_all(
            self.A, self.rels, self.elem_mats,
            self.bdr_cond_imposed, self.assemble_ess_diag)

    def get_elem_matrix(self, elno: int) -> np.ndarray:
        return self.elem_mats[elno]


class CoarseProvider(ElementMatrixProvider):
    """Coarse element matrices by AE-local RAP of the finer level."""

    def __init__(self, rels: AggPartRels, finer_level):
        # finer_level: setup.ml.Level holding (rels, tg_data) of the finer
        # level; tg_data.interp_data caches AEs_stiffm and mis_tent_interps.
        self.rels = rels          # the COARSE level's relations
        self.finer = finer_level
        # coarse dof block offsets by fine MIS (mis_coarsedofoffsets)
        self.mis_offsets = finer_level.tg_data.interp_data.mis_coarsedofoffsets

    def build_AE_stiff(self, part: int) -> np.ndarray:
        return build_AE_stiffm_local(part, self.rels, self.get_elem_matrix)

    def get_elem_matrix(self, elno: int) -> np.ndarray:
        """elmat.cpp:105-195: local tent interp over MISes in fine AE
        ``elno``, then RAP with the cached fine AE stiffness."""
        f_rels = self.finer.rels
        f_interp_data = self.finer.tg_data.interp_data
        fine_AE_stiffm = f_interp_data.AEs_stiffm[elno]
        mis_numcoarsedof = f_interp_data.mis_numcoarsedof
        mis_tent_interps = f_interp_data.mis_tent_interps

        mis_in_AE = np.sort(f_rels.AE_to_mis.row(elno))
        ae_finedof = fine_AE_stiffm.shape[0]
        coarse_elem_dofs = self.rels.elem_to_dof.row(elno)
        pos_of = {int(d): k for k, d in enumerate(coarse_elem_dofs)}
        ae_coarsedof = int(sum(mis_numcoarsedof[m] for m in mis_in_AE))

        local_interp = np.zeros((ae_finedof, ae_coarsedof))
        for mis in mis_in_AE:
            ncd = int(mis_numcoarsedof[mis])
            if ncd == 0:
                continue
            mis_dofs = f_rels.mis_to_dof.row(mis)
            rows = f_rels.dofs_local_ids_in_AE(mis_dofs, elno)
            cols = np.array(
                [pos_of[int(self.mis_offsets[mis]) + i] for i in range(ncd)],
                dtype=np.int64)
            local_interp[np.ix_(rows, cols)] += mis_tent_interps[mis][:, :ncd]
        # sparse @ dense first: fine AE stiffness is CSR for large AEs
        return local_interp.T @ (fine_AE_stiffm @ local_interp)


class ArrayProvider(ElementMatrixProvider):
    """AE matrices supplied directly (elem == AE for the algebraic path)."""

    def __init__(self, rels: AggPartRels,
                 ae_matrices: List[np.ndarray],
                 elem_matrices: Optional[List[np.ndarray]] = None):
        self.rels = rels
        self.ae_matrices = ae_matrices
        self.elem_matrices = elem_matrices

    def build_AE_stiff(self, part: int) -> np.ndarray:
        m = self.ae_matrices[part]
        if sp.issparse(m):
            return np.asarray(m.todense())
        return m

    def get_elem_matrix(self, elno: int) -> np.ndarray:
        if self.elem_matrices is not None:
            return self.elem_matrices[elno]
        return self.build_AE_stiff(elno)


class DenseArrayProvider(ElementMatrixProvider):
    """Per-element dense matrices; AE stiffness by local assembly
    (ElementMatrixDenseArray, elmat.cpp:227-253)."""

    def __init__(self, rels: AggPartRels, elem_matrices):
        self.rels = rels
        self.elem_matrices = elem_matrices

    def build_AE_stiff(self, part: int) -> np.ndarray:
        return build_AE_stiffm_local(part, self.rels, self.elem_matrices)

    def get_elem_matrix(self, elno: int) -> np.ndarray:
        return self.elem_matrices[elno]
