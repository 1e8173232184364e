"""The port's PCG loop, shared by the structured and the general path.

MFEM CGSolver semantics, as the JAX package's ``pcg_solve`` and
``struct_pcg_solve``: convergence when (B r, r) <= max(rel_tol^2
(B r0, r0), abs_tol^2).  The loop is Python: the stopping test is read
on the host once per iteration (one device sync per iteration), where
the JAX package runs it on the device (lax.while_loop); capturing it in
a CUDA graph is later work."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def pcg(matvec: Callable, precond: Callable, b: torch.Tensor,
        x0: Optional[torch.Tensor] = None, rel_tol: float = 1e-6,
        abs_tol: float = 0.0, max_iter: int = 200):
    """Returns (x, iterations, final (B r, r))."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = precond(r)
    nom = torch.dot(z, r)
    lim = torch.clamp(nom * rel_tol * rel_tol, min=abs_tol * abs_tol)
    d = z
    Ad = matvec(d)
    it = 0
    while it < max_iter and bool(nom > lim):
        alpha = nom / torch.dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        betanom = torch.dot(r, z)
        d = z + (betanom / nom) * d
        Ad = matvec(d)
        nom = betanom
        it += 1
    return x, it, nom
