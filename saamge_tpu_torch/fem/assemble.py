"""Batched FEM assembly (host path, numpy f64).

Replaces what the reference got from MFEM bilinear forms
(fem.hpp:427-484 fem_build_discrete_problem, mltest.cpp:560-620 elasticity):
diffusion and elasticity element matrices for Q1 quads/hexes and P1
tris/tets (+ Q2 quads), batched over all elements with einsum — the same
kernels are jax-traceable for the device setup path.

Element matrices are computed for ALL elements as one (NE, nd, nd) batch:
that is the shape the TPU setup path consumes directly (vmapped eigensolves
operate on gathered/padded stacks of these).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import scipy.sparse as sp

from saamge_tpu_torch.fem.mesh import Mesh
from saamge_tpu_torch.utils.tables import Table

Coefficient = Union[float, np.ndarray, Callable]


# ---------------------------------------------------------------------------
# reference elements: nodal basis on [0,1]^d simplices/cubes


def _gauss_1d(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _shape_quad_q1(pts):
    x, y = pts[:, 0], pts[:, 1]
    N = np.stack([(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y], axis=1)
    dN = np.stack([
        np.stack([-(1 - y), -(1 - x)], axis=1),
        np.stack([(1 - y), -x], axis=1),
        np.stack([y, x], axis=1),
        np.stack([-y, (1 - x)], axis=1),
    ], axis=1)  # (nq, 4, 2)
    return N, dN


def _shape_quad_q2(pts):
    # 1D quadratic nodal basis at nodes {0, 1, 1/2}
    def l(t):
        return np.stack([(1 - t) * (1 - 2 * t), t * (2 * t - 1),
                         4 * t * (1 - t)], axis=-1)

    def dl(t):
        return np.stack([4 * t - 3, 4 * t - 1, 4 - 8 * t], axis=-1)

    x, y = pts[:, 0], pts[:, 1]
    lx, ly, dlx, dly = l(x), l(y), dl(x), dl(y)
    # local node order: vertices (0,0),(1,0),(1,1),(0,1); edges bottom,right,
    # top,left; center — (ix, iy) pairs into the 1D {0,1,m} node set:
    nodes = [(0, 0), (1, 0), (1, 1), (0, 1),
             (2, 0), (1, 2), (2, 1), (0, 2), (2, 2)]
    N = np.stack([lx[:, ix] * ly[:, iy] for ix, iy in nodes], axis=1)
    dN = np.stack([np.stack([dlx[:, ix] * ly[:, iy],
                             lx[:, ix] * dly[:, iy]], axis=1)
                   for ix, iy in nodes], axis=1)
    return N, dN


def _shape_hex_q1(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    # vertex order v000,v100,v110,v010,v001,v101,v111,v011
    corners = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]

    def f(t, c):
        return t if c else 1 - t

    def df(c):
        return 1.0 if c else -1.0

    Ns, dNs = [], []
    for cx, cy, cz in corners:
        Ns.append(f(x, cx) * f(y, cy) * f(z, cz))
        dNs.append(np.stack([
            df(cx) * f(y, cy) * f(z, cz),
            f(x, cx) * df(cy) * f(z, cz),
            f(x, cx) * f(y, cy) * df(cz)], axis=1))
    return np.stack(Ns, axis=1), np.stack(dNs, axis=1)


def _shape_tri_p1(pts):
    x, y = pts[:, 0], pts[:, 1]
    N = np.stack([1 - x - y, x, y], axis=1)
    dN = np.broadcast_to(np.array([[-1., -1.], [1., 0.], [0., 1.]]),
                         (len(pts), 3, 2)).copy()
    return N, dN


def _shape_tet_p1(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    N = np.stack([1 - x - y - z, x, y, z], axis=1)
    dN = np.broadcast_to(np.array([[-1., -1., -1.], [1., 0., 0.],
                                   [0., 1., 0.], [0., 0., 1.]]),
                         (len(pts), 4, 3)).copy()
    return N, dN


def _lagrange_1d_at(nodes: np.ndarray, t: np.ndarray):
    """Values and derivatives of the 1D Lagrange basis on ``nodes``."""
    n = len(nodes)
    L = np.ones((len(t), n))
    dL = np.zeros((len(t), n))
    for j in range(n):
        for m in range(n):
            if m != j:
                L[:, j] *= (t - nodes[m]) / (nodes[j] - nodes[m])
        for k in range(n):
            if k == j:
                continue
            term = np.ones_like(t) / (nodes[j] - nodes[k])
            for m in range(n):
                if m != j and m != k:
                    term *= (t - nodes[m]) / (nodes[j] - nodes[m])
            dL[:, j] += term
    return L, dL


def nodal_lattice(elem_type: str, order: int) -> np.ndarray:
    """Reference nodal lattice for the general-order elements, in the
    SAME local order the shape functions use (tensor lex for quads/
    hexes; vertices-then-edge-midpoints for P2 simplices)."""
    t = np.linspace(0.0, 1.0, order + 1)
    if elem_type == "segment":
        return t[:, None]
    if elem_type == "quad":
        return np.array([(t[ix], t[iy])
                         for ix in range(order + 1)
                         for iy in range(order + 1)])
    if elem_type == "hex":
        return np.array([(t[ix], t[iy], t[iz])
                         for ix in range(order + 1)
                         for iy in range(order + 1)
                         for iz in range(order + 1)])
    if elem_type == "tri":
        assert order == 2, "simplices support P1/P2"
        return np.array([(0, 0), (1, 0), (0, 1),
                         (.5, 0), (.5, .5), (0, .5)], dtype=np.float64)
    if elem_type == "tet":
        assert order == 2, "simplices support P1/P2"
        v = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
                     dtype=np.float64)
        edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        mids = np.array([(v[a] + v[b]) / 2 for a, b in edges])
        return np.concatenate([v, mids], axis=0)
    raise NotImplementedError(elem_type)


def geom_shape(elem_type: str, pts: np.ndarray):
    """(Bi/tri)linear geometry shape values/grads at ``pts`` in the
    mesh's vertex ordering (used to map reference lattices to physical
    space)."""
    if elem_type == "segment":
        tt = pts[:, 0]
        N = np.stack([1 - tt, tt], axis=1)
        dN = np.broadcast_to(np.array([[-1.0], [1.0]]),
                             (len(tt), 2, 1)).copy()
        return N, dN
    return {"quad": _shape_quad_q1, "hex": _shape_hex_q1,
            "tri": _shape_tri_p1, "tet": _shape_tet_p1}[elem_type](pts)


def _shape_tensor(elem_type: str, order: int, pts: np.ndarray):
    """Arbitrary-order tensor Lagrange basis (lex lattice order)."""
    nodes = np.linspace(0.0, 1.0, order + 1)
    d = pts.shape[1]
    Ls = [(_lagrange_1d_at(nodes, pts[:, k])) for k in range(d)]
    k1 = order + 1
    idxs = nodal_lattice(elem_type, order)
    # recover integer lattice indices from coordinates
    ii = np.round(idxs * order).astype(np.int64)
    Nl, dNl = [], []
    for node in ii:
        val = np.ones(len(pts))
        for k in range(d):
            val = val * Ls[k][0][:, node[k]]
        grads = []
        for g in range(d):
            gv = np.ones(len(pts))
            for k in range(d):
                gv = gv * (Ls[k][1][:, node[k]] if k == g
                           else Ls[k][0][:, node[k]])
            grads.append(gv)
        Nl.append(val)
        dNl.append(np.stack(grads, axis=1))
    return np.stack(Nl, axis=1), np.stack(dNl, axis=1)


def _shape_tri_p2(pts):
    x, y = pts[:, 0], pts[:, 1]
    lam = [1 - x - y, x, y]
    dlam = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]),
            np.array([0.0, 1.0])]
    Ns, dNs = [], []
    for i in range(3):
        Ns.append(lam[i] * (2 * lam[i] - 1))
        dNs.append((4 * lam[i] - 1)[:, None] * dlam[i][None, :])
    for a, b in [(0, 1), (1, 2), (0, 2)]:   # lattice: e01, e12, e20 mids
        Ns.append(4 * lam[a] * lam[b])
        dNs.append(4 * (lam[a][:, None] * dlam[b][None, :]
                        + lam[b][:, None] * dlam[a][None, :]))
    return np.stack(Ns, axis=1), np.stack(dNs, axis=1)


def _shape_tet_p2(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    lam = [1 - x - y - z, x, y, z]
    dlam = [np.array([-1.0, -1.0, -1.0]), np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0])]
    Ns, dNs = [], []
    for i in range(4):
        Ns.append(lam[i] * (2 * lam[i] - 1))
        dNs.append((4 * lam[i] - 1)[:, None] * dlam[i][None, :])
    for a, b in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]:
        Ns.append(4 * lam[a] * lam[b])
        dNs.append(4 * (lam[a][:, None] * dlam[b][None, :]
                        + lam[b][:, None] * dlam[a][None, :]))
    return np.stack(Ns, axis=1), np.stack(dNs, axis=1)


def _tri_quad_deg4():
    """Dunavant 6-point degree-4 rule on the unit triangle."""
    a1, a2 = 0.445948490915965, 0.091576213509771
    w1, w2 = 0.223381589678011 / 2, 0.109951743655322 / 2
    pts = np.array([
        (a1, a1), (1 - 2 * a1, a1), (a1, 1 - 2 * a1),
        (a2, a2), (1 - 2 * a2, a2), (a2, 1 - 2 * a2)])
    wts = np.array([w1, w1, w1, w2, w2, w2])
    return pts, wts


def _tet_quad_duffy(n1: int = 3):
    """Duffy-collapsed tensor Gauss rule on the unit tetrahedron
    (always-positive weights; exact for the P2 stiffness integrands)."""
    x, w = _gauss_1d(n1)
    pts, wts = [], []
    for ia, wa in zip(x, w):
        for ib, wb in zip(x, w):
            for ic, wc in zip(x, w):
                xx = ia
                yy = ib * (1 - ia)
                zz = ic * (1 - ia) * (1 - ib)
                pts.append((xx, yy, zz))
                wts.append(wa * wb * wc * (1 - ia) ** 2 * (1 - ib))
    return np.asarray(pts), np.asarray(wts)


def reference_element(elem_type: str, order: int = 1):
    """Return (quad points (nq,d), weights (nq,), N (nq,nd), dN (nq,nd,d)).

    Quadrature orders follow mfem::DiffusionIntegrator's default rule
    (2k + dim - 1 for tensor elements, 2k - 2 for simplices), which is what
    the reference assembles with."""
    if elem_type == "quad":
        n1 = max(2, order + 1)
        x, w = _gauss_1d(n1)
        pts = np.array([(a, b) for a in x for b in x])
        wts = np.array([wa * wb for wa in w for wb in w])
        if order == 1:
            N, dN = _shape_quad_q1(pts)
        elif order == 2:
            N, dN = _shape_quad_q2(pts)
        else:
            N, dN = _shape_tensor("quad", order, pts)
    elif elem_type == "hex":
        n1 = max(3, order + 1)
        x, w = _gauss_1d(n1)
        pts = np.array([(a, b, c) for a in x for b in x for c in x])
        wts = np.array([wa * wb * wc for wa in w for wb in w for wc in w])
        if order == 1:
            N, dN = _shape_hex_q1(pts)
        else:
            N, dN = _shape_tensor("hex", order, pts)
    elif elem_type == "tri":
        if order == 1:
            pts = np.array([[1 / 3, 1 / 3]])
            wts = np.array([0.5])
            N, dN = _shape_tri_p1(pts)
        else:
            assert order == 2, "simplices support P1/P2"
            pts, wts = _tri_quad_deg4()
            N, dN = _shape_tri_p2(pts)
    elif elem_type == "tet":
        if order == 1:
            pts = np.array([[0.25, 0.25, 0.25]])
            wts = np.array([1 / 6])
            N, dN = _shape_tet_p1(pts)
        else:
            assert order == 2, "simplices support P1/P2"
            pts, wts = _tet_quad_duffy()
            N, dN = _shape_tet_p2(pts)
    else:
        raise NotImplementedError(elem_type)
    return pts, wts, N, dN


def _eval_coefficient(coef: Coefficient, mesh: Mesh,
                      matrix: bool = False) -> np.ndarray:
    """Evaluate a coefficient per element (P0 projection at element centers,
    matching the drivers' L2_0 GridFunctionCoefficient usage,
    mltest.cpp:605-611)."""
    NE, d = mesh.num_elements, mesh.dim
    if callable(coef):
        vals = np.array([coef(c) for c in mesh.elem_centers()])
    else:
        vals = np.asarray(coef, dtype=np.float64)
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (NE,)).copy()
    if matrix:
        if vals.ndim == 1:
            out = np.einsum("e,ij->eij", vals, np.eye(d))
        elif vals.shape == (d, d):
            # constant matrix coefficient (anisotropic tensor)
            out = np.broadcast_to(vals, (NE, d, d)).copy()
        else:
            out = vals.reshape(NE, d, d)
        return out
    return vals


def _inv_det_batched(J: np.ndarray):
    """Closed-form batched inverse + |det| for (..., d, d), d in {2, 3} —
    ~30x faster than np.linalg.inv's per-matrix LU on big element batches."""
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = np.empty_like(J)
        inv[..., 0, 0] = e
        inv[..., 0, 1] = -b
        inv[..., 1, 0] = -c
        inv[..., 1, 1] = a
        inv /= det[..., None, None]
        return inv, np.abs(det)
    if d == 3:
        c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
        c01 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
        c02 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
        det = (J[..., 0, 0] * c00 + J[..., 0, 1] * c01 + J[..., 0, 2] * c02)
        inv = np.empty_like(J)
        inv[..., 0, 0] = c00
        inv[..., 1, 0] = c01
        inv[..., 2, 0] = c02
        inv[..., 0, 1] = (J[..., 0, 2] * J[..., 2, 1]
                          - J[..., 0, 1] * J[..., 2, 2])
        inv[..., 1, 1] = (J[..., 0, 0] * J[..., 2, 2]
                          - J[..., 0, 2] * J[..., 2, 0])
        inv[..., 2, 1] = (J[..., 0, 1] * J[..., 2, 0]
                          - J[..., 0, 0] * J[..., 2, 1])
        inv[..., 0, 2] = (J[..., 0, 1] * J[..., 1, 2]
                          - J[..., 0, 2] * J[..., 1, 1])
        inv[..., 1, 2] = (J[..., 0, 2] * J[..., 1, 0]
                          - J[..., 0, 0] * J[..., 1, 2])
        inv[..., 2, 2] = (J[..., 0, 0] * J[..., 1, 1]
                          - J[..., 0, 1] * J[..., 1, 0])
        inv /= det[..., None, None]
        return inv, np.abs(det)
    return np.linalg.inv(J), np.abs(np.linalg.det(J))


def element_geometry(mesh: Mesh, order: int = 1):
    """Batched isoparametric geometry factors.

    Returns (detJ (NE,nq), gradN (NE,nq,nd,d)) where gradN are physical
    gradients.  Uses Q1 geometry (straight-sided elements)."""
    X = mesh.vertices[mesh.elements]            # (NE, nvert, d)
    if order == 1:
        pts, wts, N, dN = reference_element(mesh.elem_type, 1)
        # J (NE, nq, d, d): dx/dxi = sum_a X_a dN_a
        J = np.einsum("eak,qad->eqkd", X, dN, optimize=True)
        Jinv, detJ = _inv_det_batched(J)
        gradN = np.einsum("qad,eqdk->eqak", dN, Jinv, optimize=True)
        return pts, wts, N, detJ, gradN
    # higher order basis on (bi/tri)linear geometry: geometry factors
    # directly at that order's quadrature rule
    pts2, wts2, N2, dN2 = reference_element(mesh.elem_type, order)
    _, dNgeo = geom_shape(mesh.elem_type, pts2)
    J = np.einsum("eak,qad->eqkd", X, dNgeo, optimize=True)
    Jinv, detJ = _inv_det_batched(J)
    gradN = np.einsum("qad,eqdk->eqak", dN2, Jinv, optimize=True)
    return pts2, wts2, N2, detJ, gradN


def _uniform_submesh(mesh: Mesh) -> Mesh:
    import dataclasses as _dc
    sub = _dc.replace(mesh, elements=mesh.elements[:1],
                      elem_attr=mesh.elem_attr[:1])
    sub.uniform = False
    return sub


def diffusion_factorized(mesh: Mesh, coef: Coefficient = 1.0,
                         order: int = 1, matrix_coef: bool = False):
    """(em0, c) factorization of the uniform-mesh stiffness batch
    (elem_mats[e] = c[e] * em0, c None for constant-1), or None when the
    mesh/coefficient does not factorize (non-uniform mesh, matrix
    coefficient)."""
    if not (getattr(mesh, "uniform", False) and not matrix_coef
            and not (callable(coef)
                     and np.asarray(
                         coef(mesh.elem_centers()[0])).ndim == 2)
            and not (not callable(coef) and np.asarray(coef).ndim >= 2)):
        return None
    em0 = diffusion_element_matrices(_uniform_submesh(mesh), 1.0,
                                     order)[0]
    if not callable(coef) and np.ndim(coef) == 0:
        return float(coef) * em0, None
    return em0, _eval_coefficient(coef, mesh)


class FactorizedElemMats:
    """Lazy (NE, nd, nd) uniform-mesh stiffness batch: em[e] = c[e]*em0.

    Capacity feature (VERDICT r4 item 4 memory target): the materialized
    batch is 16.8 GB at the 33M-dof capacity point while the factors are
    ~260 MB.  Supports the setup consumers' access patterns — integer /
    array / slice indexing with optional trailing subscripts, ndim /
    shape / len — and the AE-assembly + device-setup paths special-case
    it (topology/agglomerate.py, setup/device_setup.py)."""

    ndim = 3

    def __init__(self, em0: np.ndarray, c: Optional[np.ndarray],
                 num_elements: int):
        self.em0 = np.asarray(em0, np.float64)
        self.c = None if c is None else np.asarray(c, np.float64)
        self.NE = num_elements

    @property
    def shape(self):
        return (self.NE,) + self.em0.shape

    @property
    def dtype(self):
        return self.em0.dtype

    def __len__(self):
        return self.NE

    def _c(self, idx):
        if self.c is not None:
            return self.c[idx]
        if isinstance(idx, (int, np.integer)):
            return 1.0
        return np.ones(len(np.arange(self.NE)[idx]))

    def __getitem__(self, idx):
        # subscript em0 FIRST so trailing indices never force the full
        # (NE, nd, nd) product (em[:, a, :] stays O(NE*nd)), and bind
        # to the correct axes for array/slice leading indices
        first, rest = (idx[0], idx[1:]) if isinstance(idx, tuple) \
            else (idx, ())
        em = self.em0[rest] if rest else self.em0
        c = np.asarray(self._c(first))
        return c.reshape(c.shape + (1,) * em.ndim) * em

    def materialize(self) -> np.ndarray:
        return self[np.arange(self.NE)]


def diffusion_element_matrices(mesh: Mesh, coef: Coefficient = 1.0,
                               order: int = 1,
                               matrix_coef: bool = False) -> np.ndarray:
    """(NE, nd, nd) stiffness batch for -div(c grad u)."""
    fac = diffusion_factorized(mesh, coef, order, matrix_coef)
    if fac is not None:
        em0, c = fac
        if c is None:
            # constant: zero-copy broadcast view
            return np.broadcast_to(em0, (mesh.num_elements,) + em0.shape)
        return c[:, None, None] * em0[None, :, :]
    pts, wts, N, detJ, gradN = element_geometry(mesh, order)
    if not callable(coef) and np.asarray(coef).ndim >= 2:
        matrix_coef = True
    if matrix_coef or (callable(coef) and
                       np.asarray(coef(mesh.elem_centers()[0])).ndim == 2):
        C = _eval_coefficient(coef, mesh, matrix=True)   # (NE, d, d)
        flux = np.einsum("ekl,eqal->eqak", C, gradN, optimize=True)
    else:
        c = _eval_coefficient(coef, mesh)                # (NE,)
        flux = c[:, None, None, None] * gradN
    # accumulate over quadrature points with batched GEMMs — one einsum over
    # the whole (e, q, a, b) tensor materializes GBs of intermediates
    w = wts[None, :] * detJ                              # (NE, nq)
    nd = gradN.shape[2]
    out = np.zeros((gradN.shape[0], nd, nd))
    for q in range(len(wts)):
        out += np.einsum("eak,ebk->eab",
                         w[:, q, None, None] * flux[:, q], gradN[:, q],
                         optimize=True)
    return out


def elasticity_element_matrices(mesh: Mesh, coef: Coefficient = 1.0,
                                lam_scale: float = 1.0,
                                mu_scale: float = 1.0) -> np.ndarray:
    """(NE, d*nd, d*nd) batch for lam div(u)div(v) + 2 mu eps(u):eps(v).

    Matches mfem::ElasticityIntegrator(coef, lam_scale, mu_scale) as used by
    the elasticity driver path (mltest.cpp:581).  DoF order is
    component-major ([all dofs comp 0, all dofs comp 1, ...]) like MFEM's
    element matrices with GetElementVDofs."""
    pts, wts, N, detJ, gradN = element_geometry(mesh, 1)
    c = _eval_coefficient(coef, mesh)
    lam = lam_scale * c
    mu = mu_scale * c
    NE, nq, nd, d = gradN.shape
    n = nd * d
    K = np.zeros((NE, n, n))
    w = wts[None, :] * detJ          # (NE, nq)
    # div-div term: (d_i N_a)(d_j N_b)
    for i in range(d):
        for j in range(d):
            blk = np.einsum("eq,e,eqa,eqb->eab", w, lam,
                            gradN[..., i], gradN[..., j], optimize=True)
            K[:, i * nd:(i + 1) * nd, j * nd:(j + 1) * nd] += blk
    # 2 mu eps:eps = mu (grad u + grad u^T) : grad v
    for i in range(d):
        for j in range(d):
            # mu * d_j N_a d_j N_b on (i,i) block
            if i == j:
                for k in range(d):
                    K[:, i * nd:(i + 1) * nd, i * nd:(i + 1) * nd] += \
                        np.einsum("eq,e,eqa,eqb->eab", w, mu,
                                  gradN[..., k], gradN[..., k], optimize=True)
            K[:, i * nd:(i + 1) * nd, j * nd:(j + 1) * nd] += \
                np.einsum("eq,e,eqa,eqb->eab", w, mu,
                          gradN[..., j], gradN[..., i], optimize=True)
    return K


def _mass_geometry(mesh: Mesh, order: int):
    """element_geometry with a quadrature exact for the MASS integrand
    N_a N_b.  The order-1 simplex rule (1-point centroid) is exact for
    P1 stiffness but only degree-1 — using it for mass yields a RANK-1
    element matrix (A/9 * ones instead of A/12 * [[2,1,1],...]); mfem's
    MassIntegrator defaults to a degree-2k rule."""
    if order == 1 and mesh.elem_type in ("tri", "tet"):
        if mesh.elem_type == "tri":
            pts, wts = _tri_quad_deg4()
            N, _ = _shape_tri_p1(pts)
        else:
            pts, wts = _tet_quad_duffy()
            N, _ = _shape_tet_p1(pts)
        X = mesh.vertices[mesh.elements]
        _, dNgeo = geom_shape(mesh.elem_type, pts)
        J = np.einsum("eak,qad->eqkd", X, dNgeo, optimize=True)
        _, detJ = _inv_det_batched(J)
        return wts, N, detJ
    pts, wts, N, detJ, _ = element_geometry(mesh, order)
    return wts, N, detJ


def mass_element_matrices(mesh: Mesh, coef: Coefficient = 1.0,
                          order: int = 1) -> np.ndarray:
    """(NE, nd, nd) mass batch for (c u, v) (mfem MassIntegrator —
    the reaction term of the secondorderpde drivers,
    secondorderpdetest.cpp:165)."""
    if getattr(mesh, "uniform", False):
        wts, N, detJ = _mass_geometry(_uniform_submesh(mesh), order)
        m0 = np.einsum("q,q,qa,qb->ab", wts, detJ[0], N, N, optimize=True)
        c = _eval_coefficient(coef, mesh)
        return c[:, None, None] * m0[None, :, :]
    wts, N, detJ = _mass_geometry(mesh, order)
    c = _eval_coefficient(coef, mesh)
    return np.einsum("q,eq,e,qa,qb->eab", wts, detJ, c, N, N,
                     optimize=True)


def domain_lf(mesh: Mesh, rhs: Coefficient = 1.0, order: int = 1,
              vdim: int = 1) -> np.ndarray:
    """Assembled load vector for (rhs, v) (DomainLFIntegrator)."""
    if getattr(mesh, "uniform", False):
        pts, wts, N, detJ, gradN = element_geometry(_uniform_submesh(mesh),
                                                    order)
        r = _eval_coefficient(rhs, mesh)
        be0 = np.einsum("q,q,qa->a", wts, detJ[0], N, optimize=True)
        be = r[:, None] * be0[None, :]
    else:
        pts, wts, N, detJ, gradN = element_geometry(mesh, order)
        r = _eval_coefficient(rhs, mesh)
        be = np.einsum("q,eq,e,qa->ea", wts, detJ, r, N,
                       optimize=True)  # (NE, nd)
    e2d = mesh.elem_to_dof(order, vdim)
    nd_total = e2d.ncols
    b = np.zeros(nd_total)
    if vdim == 1:
        np.add.at(b, e2d.indices.reshape(mesh.num_elements, -1), be)
    else:
        reps = np.tile(be, (1, vdim))
        np.add.at(b, e2d.indices.reshape(mesh.num_elements, -1), reps)
    return b


def _stencil_grid_layout(e2d: np.ndarray, grid: tuple, ndofs: int):
    """Full layout verification for the Cartesian slab assembly (cheap):
    element 0's corners decode to {0,1}^3 shifts, all elements are
    translates, and element e's base corner is the lexicographic grid
    walk.  Returns (shifts, offsets, pos) or None."""
    nx, ny, nz = grid
    ndx, ndy, ndz = nx + 1, ny + 1, nz + 1
    if ndofs != ndx * ndy * ndz or e2d.shape[1] != 8:
        return None
    sI, sJ = ndy * ndz, ndz
    shifts = []
    for a in range(8):
        v = int(e2d[0, a])
        dx, r = divmod(v, sI)
        dy, dz = divmod(r, sJ)
        if not (dx in (0, 1) and dy in (0, 1) and dz in (0, 1)):
            return None
        shifts.append((dx, dy, dz))
    rel = e2d - e2d[:, :1]
    if (rel != rel[0]).any():
        return None
    base = np.asarray(e2d[:, 0]).reshape(nx, ny, nz)
    i3, j3, k3 = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    if not np.array_equal(base, i3 * sI + j3 * sJ + k3):
        return None
    d0 = e2d[0][None, :] - e2d[0][:, None]
    offsets = np.unique(d0)
    pos = {int(o): i for i, o in enumerate(offsets)}
    return shifts, offsets, pos


def assemble_global_stencil_grid_native(
        em0: np.ndarray, c: Optional[np.ndarray], e2d: np.ndarray,
        grid: tuple, ndofs: int,
        ess_mask: Optional[np.ndarray] = None
        ) -> Optional[sp.csr_matrix]:
    """C++ slab assembly + CSR emission (native/stencil_assemble.cpp),
    with zero-Dirichlet elimination folded into the fill when
    ``ess_mask`` is given (the x0 == 0 keep_diag case of
    eliminate_essential_bc — b[ess] = 0 is the caller's side).
    Same add order and CSR layout as assemble_global_stencil_grid
    (identical pattern; values to ~1 ulp — FMA contraction); returns
    None when the layout check fails or the toolchain is unavailable."""
    import ctypes
    from saamge_tpu_torch import native
    layout = _stencil_grid_layout(e2d, grid, ndofs)
    if layout is None:
        return None
    lib = native.load("stencil_assemble")
    if lib is None:
        return None
    nx, ny, nz = grid
    ndx, ndy, ndz = nx + 1, ny + 1, nz + 1
    shifts, offsets, pos = layout
    k = len(offsets)
    sI, sJ = ndy * ndz, ndz
    off3 = np.empty((k, 3), np.int64)
    for i, o in enumerate(offsets):
        ox, r = divmod(int(o) + sI + sJ + 1, sI)
        oy, oz = divmod(r, sJ)
        off3[i] = (ox - 1, oy - 1, oz - 1)
        if off3[i, 0] * sI + off3[i, 1] * sJ + off3[i, 2] != int(o) \
                or np.abs(off3[i]).max() > 1:
            return None
    pos_arr = np.empty((8, 8), np.int64)
    d0 = e2d[0][None, :] - e2d[0][:, None]
    for a in range(8):
        for b in range(8):
            pos_arr[a, b] = pos[int(d0[a, b])]
    shifts_arr = np.asarray(shifts, np.int64)

    dbl_p = ctypes.POINTER(ctypes.c_double)
    i64_p = ctypes.POINTER(ctypes.c_int64)
    i32_p = ctypes.POINTER(ctypes.c_int32)
    u8_p = ctypes.POINTER(ctypes.c_uint8)

    def P(a, t):
        return a.ctypes.data_as(t)

    em0c = np.ascontiguousarray(em0, np.float64)
    data = np.zeros((k, ndofs), np.float64)
    cc = None if c is None else np.ascontiguousarray(c, np.float64)
    lib.stencil_diagonals(
        P(em0c, dbl_p), (P(cc, dbl_p) if cc is not None else None),
        ctypes.c_int64(nx), ctypes.c_int64(ny), ctypes.c_int64(nz),
        P(shifts_arr, i64_p), P(pos_arr, i64_p), ctypes.c_int64(k),
        P(data, dbl_p))

    offs64 = np.ascontiguousarray(offsets, np.int64)
    indices = np.empty(ndofs * k, np.int32)
    vals = np.empty(ndofs * k, np.float64)
    indptr = np.empty(ndofs + 1, np.int64)
    essu8 = None
    if ess_mask is not None:
        essu8 = np.ascontiguousarray(ess_mask, np.uint8)
    lib.stencil_csr.restype = ctypes.c_int64
    nnz = lib.stencil_csr(
        P(data, dbl_p), ctypes.c_int64(k), P(offs64, i64_p),
        P(off3, i64_p), ctypes.c_int64(ndx), ctypes.c_int64(ndy),
        ctypes.c_int64(ndz),
        (P(essu8, u8_p) if essu8 is not None else None),
        P(indices, i32_p), P(vals, dbl_p), P(indptr, i64_p))
    return sp.csr_matrix(
        (vals[:nnz], indices[:nnz], indptr), shape=(ndofs, ndofs))


def assemble_global_stencil_grid(em0: np.ndarray, c: Optional[np.ndarray],
                                 e2d: np.ndarray, grid: tuple,
                                 ndofs: int) -> Optional[sp.csr_matrix]:
    """Slab-add stencil assembly for lexicographic Cartesian hex grids.

    When the element grid is (nx, ny, nz) with dof id = i*sI + j*sJ + k
    and elements enumerated lexicographically, the contribution of local
    pair (a, b) to diagonal d0[a, b] is a CONTIGUOUS (nx, ny, nz) slab
    of the 3-D dof grid shifted by corner a's offset — so the whole
    assembly is 64 strided slab += ops with no index vectors at all
    (~10x the fancy-index version of assemble_global_stencil, which this
    falls back to via ``None`` when the layout check fails).

    ``em0``: (nd, nd) single element matrix; ``c``: optional (NE,)
    per-element scalar factors (None = all ones) — the factorized form
    of the uniform-mesh element batch (diffusion_element_matrices),
    never materializing (NE, nd, nd).

    Reference counterpart: the serial mfem/hypre assembly loop this
    replaces (fem.cpp:453-484 fem_build_discrete_problem)."""
    layout = _stencil_grid_layout(e2d, grid, ndofs)
    if layout is None:
        return None
    nx, ny, nz = grid
    ndx, ndy, ndz = nx + 1, ny + 1, nz + 1
    shifts, offsets, pos = layout
    d0 = e2d[0][None, :] - e2d[0][:, None]
    k = len(offsets)
    data = np.zeros((k, ndofs))
    data3 = data.reshape(k, ndx, ndy, ndz)
    c3 = None if c is None else np.ascontiguousarray(c).reshape(nx, ny, nz)
    for a in range(8):
        dxa, dya, dza = shifts[a]
        sl = (slice(dxa, dxa + nx), slice(dya, dya + ny),
              slice(dza, dza + nz))
        for b in range(8):
            i = pos[int(d0[a, b])]
            if c3 is None:
                data3[i][sl] += em0[a, b]
            else:
                data3[i][sl] += em0[a, b] * c3
    # touched mask per offset: union of the (a, b) slabs with that offset
    touched = np.zeros((k, ndx, ndy, ndz), dtype=bool)
    for a in range(8):
        dxa, dya, dza = shifts[a]
        sl = (slice(dxa, dxa + nx), slice(dya, dya + ny),
              slice(dza, dza + nz))
        for b in range(8):
            touched[pos[int(d0[a, b])]][sl] = True
    touched = touched.reshape(k, ndofs)
    return _stencil_csr_from_diagonals(data, touched, offsets, ndofs)



def _stencil_csr_from_diagonals(data: np.ndarray, touched: np.ndarray,
                                offsets: np.ndarray,
                                ndofs: int) -> sp.csr_matrix:
    """Shared diagonal->CSR emission for the stencil assemblers: per row
    the touched offsets in ascending order give ascending columns — no
    sort, no duplicate pass.  Column bounds are applied as slice masks
    per offset (no (ndofs, k) index arithmetic arrays)."""
    k = len(offsets)
    maskT = np.empty((ndofs, k), dtype=bool)
    for i, o in enumerate(offsets):
        o = int(o)
        maskT[:, i] = touched[i]
        if o < 0:
            maskT[:-o, i] = False
        elif o > 0:
            maskT[ndofs - o:, i] = False
    rows_sel, offs_sel = np.nonzero(maskT)
    indices = (rows_sel + offsets[offs_sel]).astype(np.int32)
    vals = data[offs_sel, rows_sel]
    indptr = np.zeros(ndofs + 1, dtype=np.int64)
    np.cumsum(maskT.sum(axis=1), out=indptr[1:])
    return sp.csr_matrix((vals, indices, indptr), shape=(ndofs, ndofs))


def assemble_global_stencil(elem_mats: np.ndarray, e2d: np.ndarray,
                            ndofs: int) -> Optional[sp.csr_matrix]:
    """Stencil-direct global assembly for translation-equivariant meshes:
    when the column-row dof difference is the same for every element and
    each local pair (a, b) — true for the structured generators — the
    global matrix is built diagonal-by-diagonal with 64 (hex) vectorized
    scatter-adds, skipping the O(NE*nd^2) COO->CSR sort entirely.
    Returns None when the equivariance check fails."""
    NE, nd, _ = elem_mats.shape
    d0 = e2d[0][None, :] - e2d[0][:, None]
    # verify equivariance for EVERY element: d[e,a,b] constant over e is
    # equivalent to (e2d[e] - e2d[e,0]) constant over e — an (NE, nd)
    # comparison, nd x cheaper than forming all pairwise diffs
    rel = e2d - e2d[:, :1]
    if (rel != rel[0]).any():
        return None
    offsets = np.unique(d0)
    pos = {int(o): i for i, o in enumerate(offsets)}
    k = len(offsets)
    data = np.zeros((k, ndofs))
    touched = np.zeros((k, ndofs), dtype=bool)
    # for a FIXED local index a the rows e2d[:, a] are one dof per
    # element and hence unique (each element contributes its a-th corner
    # exactly once), so a plain fancy-index += replaces np.add.at —
    # ~5x faster on the 884k-element flagship assembly
    rows_unique = len(np.unique(e2d[:, 0])) == NE
    for a in range(nd):
        rows = e2d[:, a]
        em_a = np.ascontiguousarray(elem_mats[:, a, :])
        for b in range(nd):
            i = pos[int(d0[a, b])]
            if rows_unique:
                data[i][rows] += em_a[:, b]
            else:
                np.add.at(data[i], rows, em_a[:, b])
            touched[i][rows] = True
    return _stencil_csr_from_diagonals(data, touched, offsets, ndofs)


def assemble_global(elem_mats: np.ndarray, elem_to_dof: Table,
                    ndofs: int) -> sp.csr_matrix:
    """Scatter-add the element-matrix batch into global CSR.

    Keeps explicit zeros in the pattern (mfem Finalize(0) semantics) so the
    AE extraction can iterate the full stencil even after BC elimination."""
    NE, nd, _ = elem_mats.shape
    dofs = elem_to_dof.indices.reshape(NE, nd).astype(np.int32)
    rows = np.repeat(dofs, nd, axis=1).ravel()
    cols = np.tile(dofs, (1, nd)).ravel()
    A = sp.coo_matrix((elem_mats.reshape(-1), (rows, cols)),
                      shape=(ndofs, ndofs)).tocsr()
    A.sort_indices()
    return A


def eliminate_essential_bc(A: sp.csr_matrix, ess_dofs: np.ndarray,
                           x: np.ndarray, b: np.ndarray,
                           keep_diag: bool = True) -> sp.csr_matrix:
    """mfem EliminateEssentialBCFromDofs(ess, x, b, keep_diag=1):

    zero rows/cols of essential dofs (keeping the pattern as explicit
    zeros), keep original diagonal, fold the boundary values into b."""
    A = A.copy()
    ess_mask = np.zeros(A.shape[0], dtype=bool)
    ess_mask[ess_dofs] = True
    diag = A.diagonal().copy()
    # b -= A[:, ess] @ x[ess] for non-essential rows
    x_e = np.where(ess_mask, x, 0.0)
    col_contrib = A @ x_e
    b -= np.where(ess_mask, 0.0, col_contrib)
    b[ess_mask] = (diag[ess_mask] * x[ess_mask]) if keep_diag \
        else x[ess_mask]
    # zero values (pattern preserved)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    kill = ess_mask[rows] | ess_mask[A.indices]
    A.data[kill] = 0.0
    # restore diagonal on essential dofs
    diag_entries = _diag_positions(A)
    keep = diag if keep_diag else np.ones_like(diag)
    A.data[diag_entries[ess_mask]] = keep[ess_mask]
    return A


def _diag_positions(A: sp.csr_matrix) -> np.ndarray:
    """Index into A.data of each row's diagonal entry (must exist)."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    pos = np.flatnonzero(A.indices == rows)
    assert len(pos) == n, "missing diagonal"
    return pos


def ess_dofs_from_attrs(mesh: Mesh, ess_attr_marker: np.ndarray,
                        order: int = 1, vdim: int = 1) -> np.ndarray:
    """Essential dof ids (GetEssentialVDofs analog, byVDIM for vdim>1)."""
    if order == 1:
        verts = mesh.ess_vertices(ess_attr_marker)
        base = verts
    elif order == 2 and mesh.elem_type == "quad":
        verts = mesh.ess_vertices(ess_attr_marker)
        # add edge dofs whose both endpoints... properly: edge dofs on marked
        # boundary edges. Boundary faces are edges for 2D.
        e2d, nd = mesh._q2_elem_to_dof()
        edge_ids = {}
        local_edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
        for e, ev in enumerate(mesh.elements):
            for le, (a, b) in enumerate(local_edges):
                key = (min(ev[a], ev[b]), max(ev[a], ev[b]))
                edge_ids.setdefault(key, int(e2d[e, 4 + le]))
        marked = set(int(v) for v in verts)
        extra = []
        for bverts, attr in zip(mesh.boundary, mesh.bdr_attr):
            if ess_attr_marker[int(attr) - 1]:
                key = (min(int(bverts[0]), int(bverts[1])),
                       max(int(bverts[0]), int(bverts[1])))
                extra.append(edge_ids[key])
        base = np.unique(np.concatenate(
            [verts, np.asarray(extra, dtype=np.int64)])) if extra else verts
    else:
        # general-order nodal path: boundary-face lattices matched by
        # quantized coordinates (mesh.ess_nodal_dofs)
        base = mesh.ess_nodal_dofs(ess_attr_marker, order)
    if vdim == 1:
        return base
    return np.concatenate([base * vdim + vd for vd in range(vdim)])


def build_discrete_problem(mesh: Mesh, coef: Coefficient = 1.0,
                           rhs: Coefficient = 1.0,
                           ess_attr_marker: Optional[np.ndarray] = None,
                           order: int = 1, elasticity: bool = False,
                           matrix_coef: bool = False,
                           lazy_elem_mats: bool = False):
    """fem_build_discrete_problem analog (fem.hpp:453-484).

    Returns (A_csr, b, elem_mats, elem_to_dof, ess_dofs).

    ``lazy_elem_mats``: when the uniform-mesh factorization applies,
    return a FactorizedElemMats instead of the materialized (NE, nd,
    nd) batch — the setup paths consume it directly (16.8 GB saved at
    the 33M-dof capacity point)."""
    vdim = mesh.dim if elasticity else 1
    if elasticity:
        if order != 1:
            raise NotImplementedError(
                "elasticity element matrices are order-1 only")
        elem_mats = elasticity_element_matrices(mesh, coef)
        b = np.zeros(mesh.num_dofs(order) * vdim)
    else:
        elem_mats = None
        if lazy_elem_mats:
            fac_l = diffusion_factorized(mesh, coef, order, matrix_coef)
            if fac_l is not None:
                elem_mats = FactorizedElemMats(fac_l[0], fac_l[1],
                                               mesh.num_elements)
        if elem_mats is None:
            elem_mats = diffusion_element_matrices(mesh, coef, order,
                                                   matrix_coef)
        b = domain_lf(mesh, rhs, order, vdim)
    e2d = mesh.elem_to_dof(order, vdim)
    if ess_attr_marker is None:
        ess_attr_marker = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    ess = ess_dofs_from_attrs(mesh, ess_attr_marker, order, vdim)
    A = None
    eliminated = False
    if (not elasticity and vdim == 1 and order == 1
            and getattr(mesh, "grid", None) is not None
            and len(mesh.grid) == 3):
        fac = diffusion_factorized(mesh, coef, order, matrix_coef)
        if fac is not None:
            em0, c = fac
            e2d_r = e2d.indices.reshape(mesh.num_elements, -1)
            ndofs = mesh.num_dofs(order)
            ess_mask = np.zeros(ndofs, dtype=bool)
            ess_mask[ess] = True
            # native path folds the zero-Dirichlet elimination into the
            # CSR fill (x0 = 0: the python eliminate reduces to zeroing
            # ess rows/cols, keeping the diagonal, and b[ess] = 0)
            A = assemble_global_stencil_grid_native(
                em0, c, e2d_r, mesh.grid, ndofs, ess_mask)
            if A is not None:
                b[ess_mask] = 0.0
                eliminated = True
            else:
                A = assemble_global_stencil_grid(
                    em0, c, e2d_r, mesh.grid, ndofs)
    if A is None and getattr(mesh, "uniform", False) and vdim == 1:
        A = assemble_global_stencil(
            elem_mats, e2d.indices.reshape(mesh.num_elements, -1),
            mesh.num_dofs(order))
    if A is None:
        em_dense = elem_mats.materialize() \
            if isinstance(elem_mats, FactorizedElemMats) else elem_mats
        A = assemble_global(em_dense, e2d, mesh.num_dofs(order) * vdim)
    if not eliminated:
        x0 = np.zeros_like(b)
        A = eliminate_essential_bc(A, ess, x0, b, keep_diag=True)
    return A, b, elem_mats, e2d, ess
