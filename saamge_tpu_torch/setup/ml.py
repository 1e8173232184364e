"""Multilevel orchestration (ml.{hpp,cpp} + levels.hpp analog)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.setup import tg as tg_mod
from saamge_tpu_torch.setup.elmat import CoarseProvider
from saamge_tpu_torch.setup.tg import TGData
from saamge_tpu_torch.solve.coarse import CorrectNullspace, VCycleCoarseSolver
from saamge_tpu_torch.topology.agglomerate import (AggPartRels,
                                             create_partitioning_coarse)
from saamge_tpu_torch.utils.logging import TIMERS, sa_print


@dataclasses.dataclass
class MultilevelParameters:
    """MultilevelParameters analog (ml.cpp:54-108): per-coarsening arrays."""

    num_coarsenings: int
    nparts_arr: List[int]
    first_nu_pro: int = 0
    nu_pro: int = 0
    # scalar, or a per-coarsening list (the reference's per-level arrays,
    # ml.cpp:54-108: nu_relax[], theta[] per level)
    nu_relax: object = 3
    first_theta: float = 0.003
    theta: object = 0.003
    polynomial_coarse_space: int = -1
    use_correct_nullspace: bool = True
    use_truncated_eigensolver: bool = False
    use_batched_eigensolver: bool = False
    do_aggregates: bool = False
    avoid_ess_bdr_dofs: bool = True
    use_double_cycle: bool = False
    coarse_direct: bool = False
    smooth_drop_tol: float = 0.0
    # relaxation root family + its parameter (smpr.cpp:376 hardcodes SAS;
    # invx needs the spectral parameter a in (0,1))
    smoother_poly_family: str = "sas"
    smoother_poly_param: float = 0.0
    # device mesh for distributed setup (sharded eigensolve batches and
    # owner-computes MIS-SVD, parallel/dist_setup.py)
    setup_mesh: object = None
    # the device of the batched setup eigensolves (use_batched_eigensolver):
    # a card ("cuda") unless the caller asks for "cpu"
    setup_device: object = "cuda"
    # upper bound on dofs per agglomerate: keeps local eigenproblems
    # bounded (the reference's design invariant, SURVEY §5) and prevents
    # a degenerate final coarsening (nparts=1 -> 1 giant AE whose
    # truncated eigensolve yields a useless 1-10 dim coarsest space)
    max_ae_dofs: int = 1024

    def get_nparts(self, j):
        return self.nparts_arr[j]

    def get_nparts_capped(self, j, fine_dim):
        """nparts adjusted so agglomerates stay under max_ae_dofs."""
        return max(self.nparts_arr[j],
                   -(-int(fine_dim) // self.max_ae_dofs))

    def get_nu_pro(self, j):
        return self.first_nu_pro if j == 0 else self.nu_pro

    def get_theta(self, j):
        if isinstance(self.theta, (list, tuple, np.ndarray)):
            return self.first_theta if j == 0 else \
                self.theta[min(j, len(self.theta) - 1)]
        return self.first_theta if j == 0 else self.theta

    def get_nu_relax(self, j):
        if isinstance(self.nu_relax, (list, tuple, np.ndarray)):
            return int(self.nu_relax[min(j, len(self.nu_relax) - 1)])
        return int(self.nu_relax)

    def get_smooth_interp(self, j):
        return self.get_nu_pro(j) > 0

    def get_polynomial_coarse_space(self, j):
        if isinstance(self.polynomial_coarse_space, (list, tuple)):
            return self.polynomial_coarse_space[j]
        return self.polynomial_coarse_space

    def set_polynomial_coarse_space(self, j, value):
        if not isinstance(self.polynomial_coarse_space, list):
            self.polynomial_coarse_space = \
                [self.polynomial_coarse_space] * self.num_coarsenings
        self.polynomial_coarse_space[j] = value

    @property
    def coarse_solver_kind(self):
        return "cg" if self.coarse_direct else "direct"


@dataclasses.dataclass
class Level:
    """levels_level_t analog: one (rels, tg_data) pair per coarsening."""
    rels: AggPartRels
    tg_data: TGData
    A: sp.csr_matrix          # the FINE operator of this coarsening


@dataclasses.dataclass
class MLData:
    levels: List[Level] = dataclasses.field(default_factory=list)
    # geometry info for polynomial/RBM coarse spaces on the finest level
    coords: Optional[np.ndarray] = None
    sdim: int = 0
    num_nodes: int = 0

    @property
    def finest(self) -> Level:
        return self.levels[0]

    @property
    def coarsest(self) -> Level:
        return self.levels[-1]


def ml_produce_data(A: sp.csr_matrix, rels: AggPartRels, elem_data,
                    mlp: MultilevelParameters,
                    coords: Optional[np.ndarray] = None,
                    sdim: int = 0, num_nodes: int = 0,
                    coarse_part_override=None, rap_override=None) -> MLData:
    """ml_produce_data (ml.cpp:379): finest coarsening then recursion.

    ``rap_override(A, tg, rels, level)``: optional Galerkin-product
    replacement (device structured RAP); None return = host product."""
    ml = MLData(coords=coords, sdim=sdim, num_nodes=num_nodes)
    from saamge_tpu_torch.utils.logging import agg_print_stats
    agg_print_stats(rels, level=3)
    sa_print(5, "Coarsening: 0 -> 1 ...")
    tg = tg_mod.tg_init_data(
        A, rels, mlp.get_nu_pro(0), mlp.get_nu_relax(0), mlp.get_theta(0),
        mlp.get_smooth_interp(0), mlp.smooth_drop_tol,
        mlp.use_truncated_eigensolver, mlp.use_batched_eigensolver,
        setup_mesh=mlp.setup_mesh, setup_device=mlp.setup_device,
        smoother_family=mlp.smoother_poly_family,
        smoother_param=mlp.smoother_poly_param)
    tg.polynomial_coarse_space = mlp.get_polynomial_coarse_space(0)
    if mlp.use_correct_nullspace and (mlp.num_coarsenings == 1
                                      or mlp.use_double_cycle):
        tg.interp_data.scaling_P = True
    tg_mod.tg_build_hierarchy(
        A, tg, rels, elem_data, mlp.avoid_ess_bdr_dofs,
        coords=coords, sdim=sdim, num_nodes=num_nodes)
    rap_fn = None
    if rap_override is not None:
        rap_fn = lambda A_, tg_: rap_override(A_, tg_, rels, 0)  # noqa: E731
    tg_mod.tg_update_coarse_operator(
        A, tg, perform_solve_init=(mlp.num_coarsenings <= 1),
        coarse_solver_kind=mlp.coarse_solver_kind, rap_fn=rap_fn)
    ml.levels.append(Level(rels=rels, tg_data=tg, A=A))
    ml_produce_hierarchy_from_level(mlp.num_coarsenings, 1, ml, mlp,
                                    coarse_part_override)
    ml_print_data(A, ml)
    return ml


def ml_produce_hierarchy_from_level(coarsenings: int, starting_level: int,
                                    ml: MLData, mlp: MultilevelParameters,
                                    coarse_part_override=None) -> None:
    """ml_produce_hierarchy_from_level (ml.cpp:111)."""
    for i in range(starting_level, coarsenings):
        finer = ml.coarsest
        A = finer.tg_data.Ac
        sa_print(5, "Coarsening: %d -> %d ...", i, i + 1)
        do_aggregates = mlp.do_aggregates and (i == coarsenings - 1)
        override = None
        if coarse_part_override is not None:
            override = coarse_part_override(i)
        with TIMERS.phase("setup.coarse_topology"):
            rels, offsets = create_partitioning_coarse(
                A, finer.rels, finer.tg_data.interp_data.mis_numcoarsedof,
                finer.tg_data.tent_interp,
                mlp.get_nparts_capped(i, A.shape[0]),
                do_aggregates=do_aggregates, partitioning=override)
        finer.tg_data.interp_data.mis_coarsedofoffsets = offsets
        tg = tg_mod.tg_init_data(
            A, rels, mlp.get_nu_pro(i), mlp.get_nu_relax(i), mlp.get_theta(i),
            mlp.get_smooth_interp(i), mlp.smooth_drop_tol,
            mlp.use_truncated_eigensolver, mlp.use_batched_eigensolver,
            setup_mesh=mlp.setup_mesh, setup_device=mlp.setup_device,
            smoother_family=mlp.smoother_poly_family,
            smoother_param=mlp.smoother_poly_param)
        tg.polynomial_coarse_space = mlp.get_polynomial_coarse_space(i)
        if mlp.use_correct_nullspace and i == coarsenings - 1:
            tg.interp_data.scaling_P = True
        emp = CoarseProvider(rels, finer)
        tg_mod.tg_build_hierarchy(A, tg, rels, emp, mlp.avoid_ess_bdr_dofs)
        tg_mod.tg_update_coarse_operator(
            A, tg, perform_solve_init=(i + 1 == coarsenings),
            coarse_solver_kind=mlp.coarse_solver_kind)
        ml.levels.append(Level(rels=rels, tg_data=tg, A=A))
    ml_impose_cycle(ml)
    if mlp.use_correct_nullspace:
        tg = ml.coarsest.tg_data
        tg.coarse_solver = CorrectNullspace(tg.Ac, tg.scaling_P, 3,
                                            smooth_phat=False, v_cycle=True)


def ml_impose_cycle(ml: MLData) -> None:
    """ml_impose_cycle (ml.cpp:361): chain V-cycles as coarse solvers."""
    for i, level in enumerate(ml.levels[:-1]):
        level.tg_data.tag = i
        level.tg_data.coarse_solver = VCycleCoarseSolver(
            ml.levels[i + 1].tg_data, level.tg_data.Ac)
    ml.coarsest.tg_data.tag = len(ml.levels) - 1


def ml_compute_OC(A: sp.csr_matrix, ml: MLData) -> float:
    return 1.0 + sum(l.tg_data.Ac.nnz for l in ml.levels) / A.nnz


def ml_print_data(A: sp.csr_matrix, ml: MLData) -> None:
    sa_print(1, "Number of levels: %d", len(ml.levels) + 1)
    sa_print(1, "Level 0 dimension: %d, Operator nnz: %d", A.shape[0], A.nnz)
    for i, level in enumerate(ml.levels):
        sa_print(1, "Level %d dimension: %d, Operator nnz: %d", i + 1,
                 level.tg_data.interp.shape[1], level.tg_data.Ac.nnz)
    sa_print(1, "Overall operator complexity: %g", ml_compute_OC(A, ml))
