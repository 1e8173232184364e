"""Plain float64 reference of the configurations' problem: -div(c grad u) =
f on the unit cube, trilinear (Q1) elements on an n x n x n grid of cubes,
zero Dirichlet values on the whole boundary, c constant per element.

Nodes are numbered i * (n+1)^2 + j * (n+1) + k for the node at (i, j, k) / n
and elements likewise on n^3, as a lexicographic hex grid numbers them.  The
operator is applied element by element from the exact element matrix of a
cube (tensor products of the 1D stiffness and mass matrices); the essential
dofs keep their diagonal and lose every other entry of their rows and
columns, and their load is zero.  Plain torch in the caller's dtype (float64
for the comparison), nothing of the program under test.

The interface the harness reads from the module that a configuration's
``reference`` names (``problem`` is the run's problem dict: the
configuration with the mix's ``problem`` keys laid over it):

- ``operator(problem, coef_seed, device)``: the float64 operator ``op(x)``;
- ``block_source(problem, block, rng)``: one ring entry's source;
- ``constant_source(problem)``: the source of the Monte Carlo load;
- ``load_vector(problem, source)``: float64, ``ndof(problem)`` entries;
- ``ndof(problem)``;
- ``residuals(op, b, x, block)``: the numbers named as the keys of the
  limits file's ``limits``.

``block_source`` and ``load_vector`` also take ``n`` in place of the
problem, as the other functions here do."""

from __future__ import annotations

import itertools

import numpy as np
import torch

CORNERS = tuple(itertools.product((0, 1), repeat=3))


def coefficients(n: int, contrast: float, seed: int) -> np.ndarray:
    """c_e = 10^U(-contrast, contrast), one draw per element in element
    order from ``numpy.random.default_rng(seed)``: the law of bench.py's
    flagship and of scripts/run_general_bench.py."""
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-contrast, contrast, n ** 3)


def element_matrix(n: int) -> np.ndarray:
    """(8, 8) stiffness matrix of one cube of side 1/n, corners in
    ``CORNERS`` order."""
    h = 1.0 / n
    k1 = np.array([[1.0, -1.0], [-1.0, 1.0]]) / h
    m1 = np.array([[2.0, 1.0], [1.0, 2.0]]) * h / 6.0
    K = np.zeros((8, 8))
    for a, ca in enumerate(CORNERS):
        for b, cb in enumerate(CORNERS):
            for d in range(3):
                f = 1.0
                for e in range(3):
                    f *= (k1 if e == d else m1)[ca[e], cb[e]]
                K[a, b] += f
    return K


def _corner(t: torch.Tensor, c, n: int) -> torch.Tensor:
    return t[c[0]:c[0] + n, c[1]:c[1] + n, c[2]:c[2] + n]


def boundary_mask(n: int, device="cpu") -> torch.Tensor:
    """(n+1)^3 bool: the essential (boundary) nodes."""
    m = torch.zeros((n + 1,) * 3, dtype=torch.bool, device=device)
    for d in range(3):
        idx = [slice(None)] * 3
        for end in (0, n):
            idx[d] = end
            m[tuple(idx)] = True
    return m.reshape(-1)


class Q1Operator:
    """y = A x of the assembled, boundary-eliminated operator, applied
    element by element in ``dtype`` on ``device``."""

    def __init__(self, n: int, coef: np.ndarray, device="cpu",
                 dtype=torch.float64):
        self.n = n
        self.K = element_matrix(n)
        self.c = torch.as_tensor(np.asarray(coef).reshape(n, n, n),
                                 dtype=dtype, device=device)
        self.ess = boundary_mask(n, device)
        diag = torch.zeros((n + 1,) * 3, dtype=dtype, device=device)
        for a, ca in enumerate(CORNERS):
            _corner(diag, ca, n).add_(self.c * self.K[a, a])
        self.diag = diag.reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        xm = torch.where(self.ess, torch.zeros_like(x), x).reshape(
            (n + 1,) * 3)
        y = torch.zeros_like(xm)
        for a, ca in enumerate(CORNERS):
            t = sum(self.K[a, b] * _corner(xm, cb, n)
                    for b, cb in enumerate(CORNERS))
            _corner(y, ca, n).add_(self.c * t)
        y = y.reshape(-1)
        return torch.where(self.ess, self.diag * x, y)


def _n(problem) -> int:
    """n of a run's problem dict, or n itself."""
    return problem["n"] if isinstance(problem, dict) else problem


def operator(problem: dict, coef_seed: int, device) -> Q1Operator:
    """The float64 operator of the field that ``coef_seed`` draws."""
    n = problem["n"]
    return Q1Operator(n, coefficients(n, problem["contrast"], coef_seed),
                      device)


def ndof(problem: dict) -> int:
    return (problem["n"] + 1) ** 3


def constant_source(problem: dict) -> np.ndarray:
    """f = 1 on every element."""
    return np.ones(problem["n"] ** 3)


def load_vector(problem, f_elem: np.ndarray) -> np.ndarray:
    """b_i = sum over the elements e at node i of f_e |e| / 8 (the exact
    integral of f times the hat function for f constant per element),
    zero on the boundary nodes."""
    n = _n(problem)
    f = np.asarray(f_elem, dtype=np.float64).reshape(n, n, n) / n ** 3 / 8.0
    b = np.zeros((n + 1,) * 3)
    for c in CORNERS:
        b[c[0]:c[0] + n, c[1]:c[1] + n, c[2]:c[2] + n] += f
    b = b.reshape(-1)
    b[boundary_mask(n).numpy()] = 0.0
    return b


def block_source(problem, block: int, rng: np.random.Generator) -> np.ndarray:
    """f per element, constant on cubes of ``block`` elements a side, each
    value U(-1, 1) from ``rng``."""
    n = _n(problem)
    nb = -(-n // block)
    vals = rng.uniform(-1.0, 1.0, (nb, nb, nb))
    idx = np.arange(n) // block
    return vals[np.ix_(idx, idx, idx)].reshape(-1)


def block_sums(v: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """Sums of a nodal vector over the cubes of ``block`` elements a side
    (node (i, j, k) in cube (i, j, k) // block, the last cube taking the
    far faces)."""
    nb = -(-n // block)
    idx = torch.clamp(torch.arange(n + 1, device=v.device) // block,
                      max=nb - 1)
    cube = (idx[:, None, None] * nb + idx[None, :, None]) * nb \
        + idx[None, None, :]
    return torch.zeros(nb ** 3, dtype=v.dtype, device=v.device).index_add_(
        0, cube.reshape(-1), v)


def residuals(op: Q1Operator, b: torch.Tensor, x: torch.Tensor,
              block: int) -> dict:
    """The numbers a solve is judged by, in the operator's dtype:
    ``res_fine`` = |b - A x| / |b| and ``res_coarse``, the same over the
    sums of both vectors on cubes of ``block`` elements a side (rounding
    in x cancels there; the smooth error of a solve stopped early does
    not)."""
    r = b - op(x)
    rc, bc = block_sums(r, op.n, block), block_sums(b, op.n, block)
    return {"res_fine": float(torch.linalg.vector_norm(r)
                              / torch.linalg.vector_norm(b)),
            "res_coarse": float(torch.linalg.vector_norm(rc)
                                / torch.linalg.vector_norm(bc))}
