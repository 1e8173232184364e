"""Plain float64 reference of 3D linear elasticity as mltest.cpp
--elasticity poses it: find u with

    a(u, v) = int lam div u div v + 2 mu eps(u) : eps(v) = int f . v

on the unit cube, trilinear (Q1) vector elements on an n x n x n grid of
cubes, lam = mu = c_e constant per element (mltest's ElasticityIntegrator
with Lame scales 1 and 1), all three components clamped (zero) on the
x = 0 face.

Departures from mltest, which reads a mesh file and puts a checkerboard
coefficient on it: the mesh is the generated unit-cube grid, and c_e =
10^U(-contrast, contrast) is drawn per element from the seed, the law of
the diffusion configurations (q1_diffusion.coefficients); the body force
is the cell's own (``block_source``, ``constant_source``).

Nodes are numbered i (n+1)^2 + j (n+1) + k for the node at (i, j, k) / n,
elements likewise on n^3, and the dofs node-major: dof 3 node + component.
The operator is applied element by element from the exact 24 x 24 element
matrix of a cube, built from tensor products of the 1D stiffness, mass and
derivative-mass matrices; the clamped dofs keep their diagonal and lose
every other entry of their rows and columns, and their load is zero.
Plain torch in float64, nothing of the program under test.

The interface the harness reads (perfbench/reference/q1_diffusion.py has
its description): ``operator``, ``block_source``, ``constant_source``,
``load_vector``, ``ndof`` and ``residuals``.  A source is (n^3, 3): the
body force of each element."""

from __future__ import annotations

import itertools

import numpy as np
import torch

CORNERS = tuple(itertools.product((0, 1), repeat=3))
CLAMPS = ("x0",)


def coefficients(n: int, contrast: float, seed: int) -> np.ndarray:
    """c_e = 10^U(-contrast, contrast), one draw per element in element
    order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-contrast, contrast, n ** 3)


def _grad_products(n: int) -> np.ndarray:
    """S[i, j, a, b] = int over one cube of side 1/n of d_i N_a d_j N_b,
    corners in ``CORNERS`` order: per axis the 1D stiffness matrix where
    both factors are differentiated, the derivative-mass matrix where one
    is, the mass matrix where neither is."""
    h = 1.0 / n
    k1 = np.array([[1.0, -1.0], [-1.0, 1.0]]) / h      # int phi_a' phi_b'
    m1 = np.array([[2.0, 1.0], [1.0, 2.0]]) * h / 6.0  # int phi_a phi_b
    d1 = np.array([[-0.5, -0.5], [0.5, 0.5]])          # int phi_a' phi_b
    S = np.ones((3, 3, 8, 8))
    for i in range(3):
        for j in range(3):
            for a, ca in enumerate(CORNERS):
                for b, cb in enumerate(CORNERS):
                    for e in range(3):
                        if e == i and e == j:
                            f = k1[ca[e], cb[e]]
                        elif e == i:
                            f = d1[ca[e], cb[e]]
                        elif e == j:
                            f = d1[cb[e], ca[e]]
                        else:
                            f = m1[ca[e], cb[e]]
                        S[i, j, a, b] *= f
    return S


def element_matrix(n: int) -> np.ndarray:
    """(24, 24) matrix of one cube with lam = mu = 1, row 3 a + i for
    corner a and component i: lam S_ij[a, b] + mu (delta_ij sum_k
    S_kk[a, b] + S_ji[a, b])."""
    S = _grad_products(n)
    lap = S[0, 0] + S[1, 1] + S[2, 2]
    K = np.zeros((8, 3, 8, 3))
    for i in range(3):
        for j in range(3):
            K[:, i, :, j] = S[i, j] + S[j, i] + (lap if i == j else 0.0)
    return K.reshape(24, 24)


def _corner(t: torch.Tensor, c, n: int) -> torch.Tensor:
    return t[c[0]:c[0] + n, c[1]:c[1] + n, c[2]:c[2] + n]


def clamped_nodes(n: int, clamp: str = "x0", device="cpu") -> torch.Tensor:
    """(n+1)^3 bool: the clamped nodes (``"x0"``: the x = 0 face)."""
    if clamp not in CLAMPS:
        raise ValueError(f"clamp {clamp!r}: expected one of {CLAMPS}")
    m = torch.zeros((n + 1,) * 3, dtype=torch.bool, device=device)
    m[0] = True
    return m.reshape(-1)


class Q1Elasticity:
    """y = A x of the assembled, clamped operator, applied element by
    element in ``dtype`` on ``device``."""

    def __init__(self, n: int, coef: np.ndarray, clamp: str = "x0",
                 device="cpu", dtype=torch.float64):
        self.n = n
        self.K = torch.as_tensor(element_matrix(n), dtype=dtype,
                                 device=device)
        self.c = torch.as_tensor(np.asarray(coef).reshape(-1), dtype=dtype,
                                 device=device)
        ess = clamped_nodes(n, clamp, device)
        self.ess = ess[:, None].expand(-1, 3).reshape(-1)
        diag = torch.zeros((n + 1,) * 3 + (3,), dtype=dtype, device=device)
        kd = torch.diagonal(self.K).reshape(8, 3)
        c3 = self.c.reshape(n, n, n, 1)
        for a, ca in enumerate(CORNERS):
            _corner(diag, ca, n).add_(c3 * kd[a])
        self.diag = diag.reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        xm = torch.where(self.ess, torch.zeros_like(x), x).reshape(
            (n + 1,) * 3 + (3,))
        xe = torch.stack([_corner(xm, cb, n).reshape(-1, 3)
                          for cb in CORNERS], 1).reshape(-1, 24)
        ye = (xe @ self.K.T) * self.c[:, None]
        y = torch.zeros_like(xm)
        for a, ca in enumerate(CORNERS):
            _corner(y, ca, n).add_(ye[:, 3 * a:3 * a + 3].reshape(n, n, n,
                                                                  3))
        return torch.where(self.ess, self.diag * x, y.reshape(-1))


def _n(problem) -> int:
    """n of a run's problem dict, or n itself."""
    return problem["n"] if isinstance(problem, dict) else problem


def _clamp(problem) -> str:
    return problem.get("clamp", "x0") if isinstance(problem, dict) else "x0"


def operator(problem: dict, coef_seed: int, device) -> Q1Elasticity:
    """The float64 operator of the field that ``coef_seed`` draws."""
    n = problem["n"]
    return Q1Elasticity(n, coefficients(n, problem["contrast"], coef_seed),
                        _clamp(problem), device)


def ndof(problem: dict) -> int:
    return 3 * (problem["n"] + 1) ** 3


def constant_source(problem: dict) -> np.ndarray:
    """f = (0, 0, -1) on every element (gravity along -z)."""
    f = np.zeros((problem["n"] ** 3, 3))
    f[:, 2] = -1.0
    return f


def load_vector(problem, f_elem: np.ndarray) -> np.ndarray:
    """b = sum over the elements e at a node of f_e |e| / 8, per
    component (the exact integral of f times the hat function for f
    constant per element), zero on the clamped dofs."""
    n = _n(problem)
    f = np.asarray(f_elem, dtype=np.float64).reshape(n, n, n, 3) \
        / n ** 3 / 8.0
    b = np.zeros((n + 1,) * 3 + (3,))
    for c in CORNERS:
        b[c[0]:c[0] + n, c[1]:c[1] + n, c[2]:c[2] + n] += f
    b[clamped_nodes(n, _clamp(problem)).numpy().reshape((n + 1,) * 3)] = 0.0
    return b.reshape(-1)


def block_source(problem, block: int, rng: np.random.Generator) -> np.ndarray:
    """f per element, (n^3, 3), constant on cubes of ``block`` elements a
    side, each of its three components U(-1, 1) a cube, from ``rng``."""
    n = _n(problem)
    nb = -(-n // block)
    vals = rng.uniform(-1.0, 1.0, (nb, nb, nb, 3))
    idx = np.arange(n) // block
    return vals[np.ix_(idx, idx, idx)].reshape(-1, 3)


def block_sums(v: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """Sums of a node-major vector field over the cubes of ``block``
    elements a side, per component (node (i, j, k) in cube (i, j, k) //
    block, the last cube taking the far faces): (cubes x 3,)."""
    nb = -(-n // block)
    idx = torch.clamp(torch.arange(n + 1, device=v.device) // block,
                      max=nb - 1)
    cube = (idx[:, None, None] * nb + idx[None, :, None]) * nb \
        + idx[None, None, :]
    out = torch.zeros((nb ** 3, 3), dtype=v.dtype, device=v.device)
    return out.index_add_(0, cube.reshape(-1), v.reshape(-1, 3)).reshape(-1)


def residuals(op: Q1Elasticity, b: torch.Tensor, x: torch.Tensor,
              block: int) -> dict:
    """The numbers a solve is judged by, in the operator's dtype:
    ``res_fine`` = |b - A x| / |b| and ``res_coarse``, the same over the
    per-component sums of both vectors on cubes of ``block`` elements a
    side (rounding in x cancels there; the smooth error of a solve
    stopped early does not)."""
    r = b - op(x)
    rc, bc = block_sums(r, op.n, block), block_sums(b, op.n, block)
    return {"res_fine": float(torch.linalg.vector_norm(r)
                              / torch.linalg.vector_norm(b)),
            "res_coarse": float(torch.linalg.vector_norm(rc)
                                / torch.linalg.vector_norm(bc))}
