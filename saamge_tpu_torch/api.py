"""Host setup of the flagship structured problem.

Builds the same setup product as the structured branch of ``bench.py``
(3D Poisson on ``hex_mesh(n)``, random high-contrast coefficients,
Cartesian brick agglomeration, three levels with a superbrick coarsest
level, theta = 1e-4, nu_relax = [3, 1]) through the JAX package's
host-only modules (numpy/scipy), with ``device_setup=False`` so that no
JAX module is imported."""

from __future__ import annotations

import numpy as np

from saamge_tpu_torch.solve.structured import BrickGeometry


def superbrick_grid(nb: int):
    """The superbrick rule of bench.py: the divisor of ``nb`` closest to
    nb / 4 (about 64 bricks per superbrick); None when that is 1."""
    sgrid = min((d for d in range(1, nb + 1) if nb % d == 0),
                key=lambda d: abs(d - nb / 4))
    return (sgrid,) * 3 if sgrid > 1 else None


def flagship_problem(n: int = 96, brick: int = 8, contrast: float = 2.0,
                     seed: int = 7, supers=None, theta: float = 1e-4,
                     mfree: bool = False):
    """Returns ``(ml, b, geo, supers)``: the host multilevel setup, the
    right-hand side, the brick geometry and the superbrick grid.  With
    ``mfree`` a fifth item ``(em0, c_elem, ess_dofs)`` is added, the
    matrix-free factors that ``compile_structured(mfree=...)`` takes."""
    from saamge_tpu.api import SpectralAMGSolver
    from saamge_tpu.config import SolverOptions
    from saamge_tpu.fem import assemble
    from saamge_tpu.fem.mesh import hex_mesh
    from saamge_tpu.topology.part import (partition_cartesian_3d,
                                          partition_cartesian_bricks)

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
                         device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, coarse_part_override=override)
    geo = BrickGeometry((nb,) * 3, (brick,) * 3)
    out = (s.ml, np.asarray(b, np.float64), geo, supers)
    if not mfree:
        return out
    fac = assemble.diffusion_factorized(mesh, coefs)
    if fac is None:
        raise ValueError("the operator does not factorize per element")
    return out + ((fac[0], fac[1], ess_dofs),)
