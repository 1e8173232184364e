"""User-facing entry points of the port.

The host solvers of the JAX package's api.py, copied (they are numpy /
scipy over the port's own copy of the host setup):
  - SpectralAMGSolver (solve.hpp:149-181): geometric, from a mesh + problem.
  - SAAMGePC (saamgepc.cpp:130): geometric preconditioner.
  - SAAMGeAlgPC (saamgealgpc.cpp): algebraic (matrix-only) preconditioner.

and the problems the port's device paths solve:
  - ``flagship_problem``: the structured flagship of bench.py (brick
    agglomeration, superbrick coarsest level) for
    solve/structured.py ``compile_structured``;
  - ``general_problem``: the hexkway problem of
    scripts/run_general_bench.py (generic k-way agglomeration) for
    solve/compiled.py ``compile_hierarchy``;
  - ``elasticity_problem``: 3D linear elasticity (mltest --elasticity)
    on the same general path, a vector field of 3 dofs a node;
  - ``entry``: the twin of __graft_entry__.entry(), one general-path
    V-cycle on the card.

The setup runs on the host with ``device_setup=False`` (the JAX
``SolverOptions`` default).  With ``device_setup=True`` the per-AE local
eigenproblems are solved batched on the device that ``setup_device``
names -- a card unless the caller asks for ``"cpu"``: the uniform-brick
pipeline (setup/device_setup.py) where the agglomeration is translation
invariant, else the bucketed batched eigensolver (ops/batched_eig.py).
Nothing imports the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saamge_tpu_torch.config import SolverOptions
from saamge_tpu_torch.fem import assemble
from saamge_tpu_torch.fem.mesh import Mesh, hex_mesh
from saamge_tpu_torch.setup import algebraic as alg
from saamge_tpu_torch.setup.elmat import GeometricProvider
from saamge_tpu_torch.setup.ml import (MLData, MultilevelParameters,
                                       ml_produce_data)
from saamge_tpu_torch.solve.pcg import PCGResult, pcg
from saamge_tpu_torch.solve.structured import BrickGeometry
from saamge_tpu_torch.solve.vcycle import VCycleSolver
from saamge_tpu_torch.topology.agglomerate import (FLAG_ESS_BDR, AggPartRels,
                                                   create_partitioning_fine)
from saamge_tpu_torch.topology.part import (partition_cartesian_3d,
                                            partition_cartesian_bricks)
from saamge_tpu_torch.utils.logging import TIMERS, sa_print


def checkerboard_coef(x: np.ndarray) -> float:
    """The drivers' high-contrast checkerboard (mltest.cpp:151-175)."""
    d = 10.0
    cx = int(np.ceil(x[0] * d)) & 1
    cy = int(np.ceil(x[1] * d)) & 1
    if len(x) == 2:
        return 1e6 if cx == cy else 1.0
    cz = int(np.ceil(x[2] * d)) & 1
    if (cz and cx == cy) or ((not cz) and cx != cy):
        return 1e6
    return 1.0


def bdr_dof_flags(mesh: Mesh, ess_attr_marker: np.ndarray, order: int = 1,
                  vdim: int = 1) -> np.ndarray:
    """fem_find_bdr_dofs (fem.cpp:87): essential-boundary flags per dof."""
    nd = mesh.num_dofs(order) * vdim
    flags = np.zeros(nd, dtype=np.uint8)
    ess = assemble.ess_dofs_from_attrs(mesh, ess_attr_marker, order, vdim)
    flags[ess] |= FLAG_ESS_BDR
    return flags


def geometric_partitioning(A: sp.csr_matrix, mesh: Mesh,
                           bdr_flags: np.ndarray, nparts: int,
                           order: int = 1, vdim: int = 1,
                           do_aggregates: bool = False,
                           partitioning: Optional[np.ndarray] = None
                           ) -> AggPartRels:
    """fem_create_partitioning (fem.cpp:687)."""
    e2d = mesh.elem_to_dof(order, vdim)
    e2e = mesh.elem_to_elem()
    return create_partitioning_fine(A, e2d, e2e, partitioning, bdr_flags,
                                    nparts, do_aggregates)


@dataclasses.dataclass
class GeometricSolveResult:
    result: PCGResult
    ml: MLData
    A: sp.csr_matrix
    b: np.ndarray


class SpectralAMGSolver:
    """One-shot geometric solver: partition -> ml_produce_data -> V-cycle
    preconditioner (solve.cpp:167-230).  With ``opts.device_setup`` the
    local eigenproblems run on ``setup_device`` (a card by default;
    ``"cpu"`` when asked; a missing card raises)."""

    def __init__(self, A: sp.csr_matrix, mesh: Mesh, elem_mats: np.ndarray,
                 opts: SolverOptions, order: int = 1, vdim: int = 1,
                 ess_attr_marker: Optional[np.ndarray] = None,
                 partitioning: Optional[np.ndarray] = None,
                 coarse_part_override=None, setup_mesh=None,
                 rap_override=None, setup_device="cuda"):
        opts = opts.resolved()
        self.opts = opts
        self.A = A
        if ess_attr_marker is None:
            ess_attr_marker = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        flags = bdr_dof_flags(mesh, ess_attr_marker, order, vdim)
        num_coarsenings = opts.num_levels - 1
        nparts0 = max(mesh.num_elements // opts.first_elems_per_agg, 1) \
            if partitioning is None else int(np.max(partitioning)) + 1
        with TIMERS.phase("setup.partitioning"):
            rels = geometric_partitioning(
                A, mesh, flags, nparts0, order, vdim,
                do_aggregates=opts.do_aggregates and num_coarsenings == 1,
                partitioning=partitioning)
        nparts_arr = [rels.nparts]
        for i in range(1, num_coarsenings):
            nparts_arr.append(max(int(round(nparts_arr[-1]
                                            / opts.elems_per_agg)), 1))
        self.mlp = MultilevelParameters(
            num_coarsenings=num_coarsenings, nparts_arr=nparts_arr,
            first_nu_pro=opts.first_nu_pro, nu_pro=opts.nu_pro,
            nu_relax=opts.nu_relax, first_theta=opts.first_theta,
            theta=opts.theta,
            polynomial_coarse_space=0 if opts.minimal_coarse else -1,
            use_correct_nullspace=opts.correct_nulspace,
            use_truncated_eigensolver=not opts.direct_eigensolver,
            use_batched_eigensolver=opts.device_setup,
            do_aggregates=opts.do_aggregates,
            use_double_cycle=opts.double_cycle,
            coarse_direct=opts.coarse_direct,
            smoother_poly_family=opts.smoother_poly_family,
            smoother_poly_param=opts.smoother_poly_param,
            setup_mesh=setup_mesh, setup_device=setup_device)
        if opts.linear_coarse or vdim > 1:
            self.mlp.set_polynomial_coarse_space(0, 1)
        emp = GeometricProvider(rels, A, elem_mats)
        coords = mesh.dof_coords(order)
        with TIMERS.phase("setup.ml_produce_data"):
            self.ml = ml_produce_data(
                A, rels, emp, self.mlp, coords=coords, sdim=mesh.dim,
                num_nodes=(mesh.num_dofs(order) if vdim == 1
                           else mesh.num_dofs(order) * vdim // vdim),
                coarse_part_override=coarse_part_override,
                rap_override=rap_override, vdim=vdim)
        if opts.double_cycle:
            from saamge_tpu_torch.solve.double_cycle import DoubleCycle
            self.precond = DoubleCycle(A, self.ml)
        else:
            self.precond = VCycleSolver(self.ml.finest.tg_data)
            self.precond.set_operator(A)

    def update_operator(self, A: sp.csr_matrix,
                        resmooth_interp: bool = True) -> None:
        """Hierarchy reuse after the operator changed (adaptation §3.5):
        fresh smoother diagonals + Galerkin products, same coarse bases
        (adapt_update_operators, adapt.cpp:189)."""
        from saamge_tpu_torch.setup.adapt import adapt_update_operators_ml
        self.A = A.tocsr()
        adapt_update_operators_ml(self.A, self.ml, self.mlp, resmooth_interp)
        self.precond.set_operator(self.A)

    def mult(self, r: np.ndarray) -> np.ndarray:
        z = np.zeros_like(r)
        self.precond.mult(r, z)
        return z

    def solve(self, b: np.ndarray, x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> PCGResult:
        with TIMERS.phase("solve.pcg"):
            res = pcg(self.A, b, self.mult, x0=x0,
                      rel_tol=self.opts.rtol, max_iter=self.opts.maxiter,
                      verbose=verbose)
        if res.converged:
            sa_print(1, "Outer PCG converged in %d iterations.",
                     res.iterations)
        else:
            sa_print(1, "Outer PCG failed to converge after %d iterations!",
                     res.iterations)
        return res


# convenient alias matching the reference preconditioner class name
SAAMGePC = SpectralAMGSolver


class SAAMGeAlgPC:
    """Algebraic preconditioner (saamgealgpc.cpp): matrix in, V-cycle out."""

    def __init__(self, A: sp.csr_matrix, opts: Optional[SolverOptions] = None,
                 use_window: bool = False, eliminate_dof0: bool = True):
        opts = (opts or SolverOptions(theta=0.01, correct_nulspace=False)
                ).resolved()
        self.opts = opts
        self.A_full = A.tocsr()
        self.k_elim = 1 if eliminate_dof0 else 0
        Al = alg.eliminate_dof0(self.A_full) if eliminate_dof0 \
            else self.A_full
        nparts = max(Al.shape[0] // opts.first_elems_per_agg, 1)
        with TIMERS.phase("setup.partitioning"):
            self.rels = alg.create_partitioning_from_matrix(Al, nparts)
        with TIMERS.phase("setup.algebraic"):
            self.tg = alg.tg_produce_data_algebraic(
                Al, self.rels, opts.first_nu_pro, opts.nu_relax,
                opts.first_theta, smooth_interp=opts.first_nu_pro > 0,
                polynomial_coarse=0 if opts.minimal_coarse else -1,
                use_window=use_window,
                use_truncated_eigensolver=True)
        if self.k_elim:
            from saamge_tpu_torch.setup.tg import tg_augment_interp_with_identity
            tg_augment_interp_with_identity(self.tg, self.k_elim)
        from saamge_tpu_torch.setup.tg import tg_fillin_coarse_operator
        tg_fillin_coarse_operator(self.A_full, self.tg,
                                  perform_solve_init=False)
        from saamge_tpu_torch.solve.coarse import CGSolver
        self.tg.coarse_solver = CGSolver(self.tg.Ac)
        # relaxation data must match the FULL operator
        from saamge_tpu_torch.solve import smoothers
        self.tg.poly_data = smoothers.init_poly_data(
            self.A_full, opts.nu_relax, opts.smoother_poly_family,
            opts.smoother_poly_param)
        self.precond = VCycleSolver(self.tg)
        self.precond.set_operator(self.A_full)

    def mult(self, r: np.ndarray) -> np.ndarray:
        z = np.zeros_like(r)
        self.precond.mult(r, z)
        return z

    def solve(self, b: np.ndarray, x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> PCGResult:
        res = pcg(self.A_full, b, self.mult, x0=x0, rel_tol=self.opts.rtol,
                  max_iter=self.opts.maxiter, verbose=verbose)
        sa_print(1, "Outer PCG %s in %d iterations.",
                 "converged" if res.converged else "did NOT converge",
                 res.iterations)
        return res


# ---------------------------------------------------------------------------
# the problems of the port's device paths


def superbrick_grid(nb: int):
    """The superbrick rule of bench.py: the divisor of ``nb`` closest to
    nb / 4 (about 64 bricks per superbrick); None when that is 1."""
    sgrid = min((d for d in range(1, nb + 1) if nb % d == 0),
                key=lambda d: abs(d - nb / 4))
    return (sgrid,) * 3 if sgrid > 1 else None


def flagship_problem(n: int = 96, brick: int = 8, contrast: float = 2.0,
                     seed: int = 7, supers=None, theta: float = 1e-4,
                     mfree: bool = False, device_setup: bool = False,
                     device="cuda"):
    """The host setup of the structured branch of ``bench.py`` (3D
    Poisson on ``hex_mesh(n)``, random high-contrast coefficients,
    Cartesian brick agglomeration, three levels with a superbrick
    coarsest level, theta, nu_relax = [3, 1]).  Returns ``(ml, b, geo,
    supers)``: the host multilevel setup, the right-hand side, the brick
    geometry and the superbrick grid.  With ``mfree`` a fifth item
    ``(em0, c_elem, ess_dofs)`` is added, the matrix-free factors that
    ``compile_structured(mfree=...)`` takes.  ``device_setup`` solves
    the local eigenproblems on ``device`` (a card, or ``"cpu"``) as
    ``bench.py`` does, else on the host."""
    if n % brick:
        raise ValueError(f"brick size {brick} does not divide n={n}")
    nb = n // brick
    if supers is None:
        supers = superbrick_grid(nb)
    if supers is None:
        raise ValueError(f"no superbrick grid for {nb}^3 bricks; pass "
                         "supers explicitly")
    supers = tuple(int(s) for s in supers)
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(seed)
    coefs = 10.0 ** rng.uniform(-contrast, contrast, mesh.num_elements)
    A, b, em, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)

    def override(level):
        return partition_cartesian_bricks((nb,) * 3, supers)

    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         first_theta=theta, theta=theta, nu_relax=[3, 1],
                         device_setup=device_setup)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, coarse_part_override=override,
                          setup_device=device)
    geo = BrickGeometry((nb,) * 3, (brick,) * 3)
    out = (s.ml, np.asarray(b, np.float64), geo, supers)
    if not mfree:
        return out
    fac = assemble.diffusion_factorized(mesh, coefs)
    if fac is None:
        raise ValueError("the operator does not factorize per element")
    return out + ((fac[0], fac[1], ess_dofs),)


def general_problem(n: int = 64, contrast: float = 2.0, seed: int = 7,
                    elems_per_agg: int = 512, levels: int = 3,
                    theta: float = 1e-4, device_setup: bool = False,
                    device="cuda"):
    """The hexkway host setup of scripts/run_general_bench.py: 3D
    Poisson on ``hex_mesh(n)`` with coefficients 10^U(-contrast,
    contrast) from ``seed``, agglomerated by the generic k-way
    partitioner (native/partition.cpp; ``partitioning=None``), not the
    brick fast path.  ``device_setup`` solves the local eigenproblems
    on ``device`` (a card, or ``"cpu"``) through the batched eigensolver,
    as the script does on its accelerator.  Returns ``(ml, A, b)``."""
    mesh = hex_mesh(n)
    rng = np.random.default_rng(seed)
    coef = 10.0 ** rng.uniform(-contrast, contrast, mesh.num_elements)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(
        num_levels=levels, correct_nulspace=False, first_theta=theta,
        theta=theta, nu_relax=[3, 1] if levels >= 3 else 3,
        first_elems_per_agg=elems_per_agg, elems_per_agg=elems_per_agg,
        device_setup=device_setup)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          setup_device=device)
    return s.ml, A, np.asarray(b, np.float64)


def elasticity_problem(n: int = 40, contrast: float = 2.0, seed: int = 7,
                       first_elems_per_agg: int = 128,
                       elems_per_agg: int = 64, levels: int = 3,
                       theta: float = 1e-4, clamp_attrs=(1,),
                       device_setup: bool = False, device="cuda"):
    """3D linear elasticity as mltest.cpp --elasticity sets it up
    (mltest.cpp:560-620): lam div u div v + 2 mu eps(u):eps(v) on
    ``hex_mesh(n)``, both Lame parameters c_e = 10^U(-contrast,
    contrast) from ``seed`` (the draw of ``general_problem``), all three
    components clamped on the boundary attributes ``clamp_attrs`` (1:
    the x = 0 face), three dofs a node numbered node-major.  The setup
    is ``general_problem``'s generic k-way path with
    ``first_elems_per_agg`` elements an agglomerate at the first
    coarsening and ``elems_per_agg`` after it; ``vdim=3`` takes the
    rigid-body modes into the finest coarse space.  ``device_setup``
    solves the local eigenproblems on ``device`` (a card, or
    ``"cpu"``).  Returns ``(ml, A, b)``; b is zero (the caller brings
    the load)."""
    mesh = hex_mesh(n)
    rng = np.random.default_rng(seed)
    coef = 10.0 ** rng.uniform(-contrast, contrast, mesh.num_elements)
    ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
    ess[np.asarray(clamp_attrs, dtype=np.int64) - 1] = 1
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, ess_attr_marker=ess, elasticity=True)
    opts = SolverOptions(
        num_levels=levels, correct_nulspace=False, first_theta=theta,
        theta=theta, nu_relax=[3, 1] if levels >= 3 else 3,
        first_elems_per_agg=first_elems_per_agg,
        elems_per_agg=elems_per_agg, device_setup=device_setup)
    s = SpectralAMGSolver(A, mesh, em, opts, vdim=mesh.dim,
                          ess_attr_marker=ess, setup_device=device)
    return s.ml, A, np.asarray(b, np.float64)


def entry(device="cuda"):
    """(fn, example_args): one general-path V-cycle application
    ``vcycle_apply(h, b)`` on 3D Poisson (``hex_mesh(12)``, constant
    coefficient, 2 levels, 64 elements per agglomerate), the twin of
    __graft_entry__.entry(), with the hierarchy and b on ``device``."""
    from saamge_tpu_torch.solve.compiled import (compile_hierarchy,
                                                 vcycle_apply)
    mesh = hex_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=64, elems_per_agg=64)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    h = compile_hierarchy(s.ml, torch.float32, device=device)
    return vcycle_apply, (h, torch.as_tensor(b, dtype=torch.float32,
                                             device=device))
