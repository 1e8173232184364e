"""Batched element-matrix assembly on the device.

Port of saamge_tpu/fem/assemble_jax.py.  The element-matrix batch is the
FLOP-heavy part of FEM assembly (fem_build_discrete_problem,
fem.hpp:427-484) and a pure batched pipeline: geometry Jacobians
(closed-form batched inverse and determinant), physical gradients, and
the quadrature-weighted stiffness contraction, chunked over elements to
bound device memory.  float32 with TF32 off (``_device``) on
element-local vertex coordinates; results return as float32 numpy, as
in JAX.  The numpy f64 path in fem/assemble.py stays the reference and
does the global assembly.

Not ported: the padding of the last chunk to one compiled shape
(assemble_jax.py:88-93), an XLA recompile guard."""

from __future__ import annotations

import numpy as np
import torch

from saamge_tpu_torch._device import card_or_cpu
from saamge_tpu_torch.fem import assemble as host
from saamge_tpu_torch.fem.mesh import Mesh


def _inv_det(J: torch.Tensor):
    """Closed-form inverse and |det| of (..., d, d), d in {2, 3}."""
    d = J.shape[-1]

    def e(r, c):
        return J[..., r, c]

    if d == 2:
        det = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        inv = torch.stack([torch.stack([e(1, 1), -e(0, 1)], -1),
                           torch.stack([-e(1, 0), e(0, 0)], -1)], -2)
        return inv / det[..., None, None], det.abs()
    if d != 3:
        raise ValueError(f"dimension {d}: expected 2 or 3")
    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c01 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c02 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    det = e(0, 0) * c00 + e(0, 1) * c01 + e(0, 2) * c02
    r0 = torch.stack([c00,
                      e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
                      e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)], -1)
    r1 = torch.stack([c01,
                      e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
                      e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)], -1)
    r2 = torch.stack([c02,
                      e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
                      e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)], -1)
    inv = torch.stack([r0, r1, r2], -2) / det[..., None, None]
    return inv, det.abs()


def _diffusion_chunk(X, dN, wts, coef_e):
    """X (E, nv, d) vertex coords; dN (nq, nd, d) reference gradients;
    wts (nq,); coef_e (E,) scalar coefficient.  Returns (E, nd, nd)."""
    J = torch.einsum("eak,qad->eqkd", X, dN)
    Jinv, detJ = _inv_det(J)
    gradN = torch.einsum("qad,eqdk->eqak", dN, Jinv)
    w = wts[None, :] * detJ * coef_e[:, None]            # (E, nq)
    return torch.einsum("eq,eqak,eqbk->eab", w, gradN, gradN)


def diffusion_element_matrices(mesh: Mesh, coef=1.0, chunk: int = 1 << 15,
                               device="cuda") -> np.ndarray:
    """Device twin of assemble.diffusion_element_matrices (scalar or
    per-element coefficients; order 1), on ``device`` (a card unless
    ``"cpu"`` is asked for); float32 numpy (NE, nd, nd)."""
    dev = card_or_cpu(device)
    pts, wts, N, dN = host.reference_element(mesh.elem_type, 1)
    c = host._eval_coefficient(coef, mesh)
    # each element's vertices relative to its first vertex, formed in f64
    # (J is unchanged: the reference gradients sum to zero); the JAX twin
    # rounds the absolute coordinates to f32, whose differences lose
    # digits as the elements shrink
    X = mesh.vertices[mesh.elements]
    X = (X - X[:, :1]).astype(np.float32)
    dN_d = torch.as_tensor(dN, dtype=torch.float32, device=dev)
    wts_d = torch.as_tensor(wts, dtype=torch.float32, device=dev)
    NE = mesh.num_elements
    nd = dN.shape[1]
    chunk = min(chunk, -(-NE // max(NE // chunk, 1)))
    out = np.empty((NE, nd, nd), dtype=np.float32)
    for lo in range(0, NE, chunk):
        hi = min(lo + chunk, NE)
        Xc = torch.as_tensor(X[lo:hi]).to(dev)
        cc = torch.as_tensor(c[lo:hi], dtype=torch.float32).to(dev)
        out[lo:hi] = _diffusion_chunk(Xc, dN_d, wts_d, cc).cpu().numpy()
    return out


def build_discrete_problem(mesh: Mesh, coef=1.0, rhs=1.0,
                           ess_attr_marker=None, order: int = 1,
                           device="cuda"):
    """Device-assembled analog of assemble.build_discrete_problem for the
    scalar diffusion case: the element matrices on ``device``, the global
    assembly, right-hand side and boundary elimination on the host."""
    if order != 1:
        raise ValueError(f"order {order}: the device assembly is order 1")
    elem_mats = diffusion_element_matrices(mesh, coef,
                                           device=device).astype(np.float64)
    b = host.domain_lf(mesh, rhs, order, 1)
    e2d = mesh.elem_to_dof(order, 1)
    A = host.assemble_global(elem_mats, e2d, mesh.num_dofs(order))
    ess = np.zeros(0, dtype=np.int64)
    if ess_attr_marker is not None:
        ess = host.ess_dofs_from_attrs(mesh, ess_attr_marker, order, 1)
        x0 = np.zeros_like(b)
        A = host.eliminate_essential_bc(A, ess, x0, b)
        b[ess] = 0.0
    return A, b, elem_mats, e2d, ess
