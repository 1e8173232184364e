"""The general (unstructured) solve phase: multilevel V-cycle + PCG.

Port of saamge_tpu/solve/compiled.py: polynomial smoothers (chains of
roots), residual/restriction/prolongation products on DIA / banded /
ELL / block-row device matrices, an exact coarsest solve and a PCG
around it, for any host setup product (``MLData``) of the port's
host setup.

Format choice (compiled.py:87-113 of the JAX package): coarse operators
are block-row when the finer level's MIS offsets number their rows; the
tentative P/R are block-row when the interpolation is not smoothed;
otherwise DIA (<= 40 diagonals) > banded > ELL by structure, and ELL for
smoothed P/R.

The finest level of a vector-valued setup (``MLData.vdim`` 3, 3D
elasticity) is stored f32 in the node-block stencil format
(ops/sparse.NodeBlock) when its 3 x 3 node blocks lie on at most 27 node
offsets; every scalar level keeps the choice above.

Smoothing.  Every f32 DIA level without a second root chain smooths
through the fused smoother kernel (ops/smoother.py): all roots in one
launch, the pre-smoothing launch emitting the residual too.  A
node-block level without a second root chain does the same through the
node-block chain (ops/vstencil.py, csrc/vstencil.cu), and its products
are that kernel's spmv and residual passes.  This
replaces both JAX branches, the VMEM-resident fused smoother
(``fits_vmem``) and the blocked stencil passes above that budget.  On a
block-row level each root and the residual are one pass of the
block-row kernel (ops/blockrow.py: f32 on the card), as are the
block-row R and P products.  The other levels (f64 DIA, banded, ELL, or
the invx family's two chains) run the plain torch chain, as JAX runs an
XLA scan there.  The f32 products of
a DIA operator (the residual of a W-cycle's later visits, the PCG
operator) are the stencil kernel (ops/stencil.py); an f64 DIA product
is plain torch, as XLA's is in JAX.

The coarsest solve applies the explicit inverse of the SPD coarsest
operator, formed in f64 from the host f64 Cholesky factor and rounded to
the hierarchy's dtype, as one product with its lower-triangle tiles
(ops/symv.py, csrc/symv.cu); the JAX package solves the factor twice
(``solve_triangular``).

Reference counterparts: tg_cycle_atb (tg.cpp:91), smpr_sym_poly /
smpr_compute_poly (smpr.cpp:213, smpr.hpp:319), the MFEM CGSolver
(mfem_addons.cpp:106), the HypreDirect coarse solve (tg.cpp:61)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saamge_tpu_torch.ops.blockrow import (BlockRow, TransposedBlockRow,
                                           blockrow)
from saamge_tpu_torch.ops.smoother import inv_taus_f32, smoother_h
from saamge_tpu_torch.ops.sparse import (DIA, ELL, NodeBlock, device_matrix,
                                         dia_spmv)
from saamge_tpu_torch.ops.stencil import stencil_h
from saamge_tpu_torch.ops.symv import pack_lower, symv
from saamge_tpu_torch.ops.vstencil import vstencil
from saamge_tpu_torch.solve.device_pcg import graphed, pcg
from saamge_tpu_torch.utils.logging import TIMERS


def _cast_floats(values, dtype) -> tuple:
    """Python floats rounded to ``dtype`` (the JAX package stores the
    roots as arrays of the hierarchy's dtype)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return tuple(float(v) for v in np.asarray(values, np_dt).reshape(-1))


class CompiledLevel(torch.nn.Module):
    """One level: operator A, prolongation P, restriction R, smoother
    scaling ``dinv`` and roots.  A DIA operator keeps its values in the
    buffer ``A_vals`` (``A`` rebuilds the view); the other formats are
    submodules.  ``fused`` marks an f32 DIA level smoothed by the fused
    kernel, ``blocked`` an f32 node-block level smoothed by the
    node-block chain; either has ``dinvh``, its haloed scaling, and
    ``inv_taus``, the f32 1/tau of its roots."""

    def __init__(self, A, P, R, dinv: torch.Tensor, roots, roots2=(),
                 weightfirst: float = 1.0):
        super().__init__()
        self.n = int(A.shape[0])
        dtype = dinv.dtype
        if isinstance(A, DIA):
            self.offsets = tuple(A.offsets)
            self.register_buffer("A_vals", A.vals)
            self.A_mod = None
        else:
            self.offsets = None
            self.A_mod = A
        self.P = P
        self.R = R
        self.register_buffer("dinv", dinv)
        self.roots = _cast_floats(roots, dtype)
        self.roots2 = _cast_floats(roots2, dtype)
        self.weightfirst = _cast_floats([weightfirst], dtype)[0]
        chained = (isinstance(A, (DIA, NodeBlock)) and not self.roots2
                   and dtype == torch.float32
                   and A.vals.dtype == torch.float32)
        self.fused = chained and isinstance(A, DIA)
        self.blocked = chained and isinstance(A, NodeBlock)
        one_launch = self.fused or self.blocked
        self.inv_taus = inv_taus_f32(roots) if one_launch else None
        self.register_buffer(
            "dinvh", A.pad(dinv) if one_launch else None)

    @property
    def A(self):
        if self.offsets is not None:
            return DIA(self.A_vals, self.offsets, self.n)
        return self.A_mod

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: the stencil kernel for f32 DIA values, plain torch
        for f64 DIA, the node-block pass for a node-block operator, the
        format's own product otherwise."""
        A = self.A
        if isinstance(A, NodeBlock):
            return A.unpad(vstencil(A, "spmv", A.pad(x)))
        if not isinstance(A, DIA):
            return A.matvec(x)
        if A.vals.dtype == torch.float32 and x.dtype == torch.float32:
            return A.unpad(stencil_h("spmv", A, A.pad(x)))
        return dia_spmv(A, x)

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """b - A x: one pass of the block-row kernel (ops/blockrow.py)
        on a block-row operator, else b minus ``matvec``."""
        if isinstance(self.A_mod, BlockRow):
            return blockrow(self.A_mod, x, "residual", b)
        return b - self.matvec(x)

    def root(self, x: torch.Tensor, b: torch.Tensor,
             tau: float) -> torch.Tensor:
        """One smoother root x + (dinv (b - A x)) / tau: one pass of the
        block-row kernel on a block-row operator, else the plain chain."""
        if isinstance(self.A_mod, BlockRow):
            return blockrow(self.A_mod, x, "root", b, self.dinv, tau)
        return x + (self.dinv * (b - self.matvec(x))) / tau

    def chain_h(self, bh: torch.Tensor, xh: torch.Tensor,
                emit_residual: bool = False):
        """All roots (and with ``emit_residual`` the trailing residual)
        over haloed vectors in one launch, on a ``fused`` or ``blocked``
        level; returns xh' or (xh', resh)."""
        if self.fused:
            return smoother_h(self.A, self.inv_taus, bh, self.dinvh, xh,
                              emit_residual)
        return vstencil(self.A_mod, "chain", xh, bh, self.dinvh,
                        self.inv_taus, emit_residual)

    def residual_h(self, xh: torch.Tensor, bh: torch.Tensor):
        """b - A x over haloed vectors on a DIA or node-block level."""
        if isinstance(self.A_mod, NodeBlock):
            return vstencil(self.A_mod, "residual", xh, bh)
        return stencil_h("residual", self.A, xh, bh)


class CompiledHierarchy(torch.nn.Module):
    """Static solve-phase hierarchy; build once from an MLData with
    ``compile_hierarchy``.  ``coarse_inv`` is the inverse of the
    coarsest operator (``coarse_n`` dofs) as the lower-triangle tiles of
    ops/symv.pack_lower."""

    def __init__(self, levels, coarse_inv: torch.Tensor, coarse_n: int):
        super().__init__()
        self.levels = torch.nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.coarse_n = int(coarse_n)

    @property
    def n(self) -> int:
        return self.levels[0].n


def _level(A: sp.spmatrix, tg, dtype, A_dev, P_dev=None, R_dev=None):
    pd = tg.poly_data
    if P_dev is None:
        P_dev = ELL.from_csr(tg.interp, dtype)
        R_dev = ELL.from_csr(tg.restr, dtype)
    roots2 = np.asarray(pd.roots2) if pd.roots2 is not None else ()
    return CompiledLevel(
        A_dev, P_dev, R_dev,
        torch.as_tensor(np.asarray(pd.dinv, np.float64)).to(dtype),
        pd.roots, roots2, pd.weightfirst)


def coarse_inverse(L: torch.Tensor, dtype, device) -> torch.Tensor:
    """The packed inverse (ops/symv.pack_lower) of L L^T, L a lower
    Cholesky factor: inverted in f64 on ``device``, rounded to ``dtype``,
    then packed there."""
    inv = torch.cholesky_inverse(L.to(device=device, dtype=torch.float64))
    return pack_lower(inv.to(dtype))


def _coarse_inverse(Ac: sp.spmatrix, dtype, device) -> torch.Tensor:
    """``coarse_inverse`` of the host f64 Cholesky factor of the
    coarsest operator."""
    return coarse_inverse(torch.as_tensor(np.linalg.cholesky(Ac.toarray())),
                          dtype, device)


@TIMERS.phase("compile")
def compile_hierarchy(ml, dtype=torch.float32, prefer_dia: bool = True,
                      use_block_row: bool = True,
                      device="cuda") -> CompiledHierarchy:
    """Convert a host MLData (setup product) into device arrays on
    ``device`` (the card unless the caller asks for "cpu").  The call is
    the phase ``compile`` of utils/logging.TIMERS, its stages phases
    inside it: the levels' operators, restrictions and prolongations
    (``compile.levels``), the host Cholesky factor of the coarsest
    operator and its packed inverse (``compile.coarsest_inverse``: the
    inverse formed on ``device``) and the module
    (``compile.module``: the copy to ``device``)."""
    levels = []
    with TIMERS.phase("compile.levels"):
        for i, level in enumerate(ml.levels):
            tg = level.tg_data
            A_dev = P_dev = R_dev = None
            if i == 0 and ml.vdim == NodeBlock.BS \
                    and dtype == torch.float32:
                A_dev = NodeBlock.try_from_csr(level.A, dtype)
                if A_dev is not None:
                    TIMERS.count("vstencil.bytes",
                                 A_dev.vals.numel()
                                 * A_dev.vals.element_size())
            if use_block_row and i > 0:
                finer = ml.levels[i - 1].tg_data
                offs = getattr(finer.interp_data, "mis_coarsedofoffsets",
                               None)
                if offs is not None and offs[-1] == level.A.shape[0]:
                    A_dev = BlockRow.from_csr(
                        level.A, np.asarray(offs, np.int64), dtype)
            if A_dev is None:
                A_dev = device_matrix(level.A, dtype, prefer_dia)
            if use_block_row and not tg.smooth_interp:
                # tentative P/R have dense MIS row blocks too (R row group
                # m = MIS m's coarse dofs, columns = MIS m's fine dofs)
                offs = getattr(tg.interp_data, "mis_coarsedofoffsets", None)
                if offs is not None and offs[-1] == tg.restr.shape[0]:
                    R_dev = BlockRow.from_csr(
                        tg.restr, np.asarray(offs, np.int64), dtype)
                    P_dev = TransposedBlockRow(R_dev)
            levels.append(_level(level.A, tg, dtype, A_dev, P_dev, R_dev))
    Ac = ml.levels[-1].tg_data.Ac
    with TIMERS.phase("compile.coarsest_inverse"):
        inv = _coarse_inverse(Ac, dtype, device)
    with TIMERS.phase("compile.module"):
        return CompiledHierarchy(levels, inv, Ac.shape[0]).to(device)


def compile_two_level(A: sp.spmatrix, tg, dtype=torch.float32,
                      prefer_dia: bool = True,
                      device="cuda") -> CompiledHierarchy:
    """Compile a bare TGData (two-level / algebraic path)."""
    lv = _level(A, tg, dtype, device_matrix(A, dtype, prefer_dia))
    return CompiledHierarchy([lv], _coarse_inverse(tg.Ac, dtype, device),
                             tg.Ac.shape[0]).to(device)


# ---------------------------------------------------------------------------
# the cycle


def smooth(lv: CompiledLevel, b: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """smpr_sym_poly / smpr_compute_poly: x += D^{-1} (b - A x) / tau per
    root; the invx family mixes two root chains with weightfirst
    (smpr.cpp:213-234)."""
    if lv.fused or lv.blocked:
        A = lv.A
        return A.unpad(lv.chain_h(A.pad(b), A.pad(x)))

    if not lv.roots2:
        for tau in lv.roots:
            x = lv.root(x, b, tau)
        return x

    def chain(x, roots):
        for tau in roots:
            x = x + (lv.dinv * (b - lv.matvec(x))) / tau
        return x

    w = lv.weightfirst
    return w * chain(x, lv.roots) + (1.0 - w) * chain(x, lv.roots2)


def coarse_solve(h: CompiledHierarchy, b: torch.Tensor) -> torch.Tensor:
    """The exact coarsest solve: one product with the packed inverse."""
    return symv(h.coarse_inv, b)


def vcycle(h: CompiledHierarchy, b: torch.Tensor, x: torch.Tensor,
           level: int = 0, mu: int = 1) -> torch.Tensor:
    """tg_cycle_atb over the levels; mu=2 gives the W-cycle (each coarse
    visit recurses mu times)."""
    lv = h.levels[level]

    def coarse_correct(resc):
        if level + 1 < len(h.levels):
            xc = resc.new_zeros(h.levels[level + 1].n)
            return vcycle(h, resc, xc, level + 1, mu)
        return coarse_solve(h, resc)

    if lv.fused or lv.blocked:
        # the iterate stays haloed across the smoothing launches; the
        # pre-smoothing launch emits the first residual
        A = lv.A
        bh = A.pad(b)
        xh, resh = lv.chain_h(bh, A.pad(x), emit_residual=True)
        for cycle in range(mu):
            if cycle:
                resh = lv.residual_h(xh, bh)
            xc = coarse_correct(lv.R.matvec(A.unpad(resh)))
            xh = xh + A.pad(lv.P.matvec(xc))
        return A.unpad(lv.chain_h(bh, xh))

    x = smooth(lv, b, x)
    for _ in range(mu):
        xc = coarse_correct(lv.R.matvec(lv.residual(x, b)))
        x = x + lv.P.matvec(xc)
    return smooth(lv, b, x)


def precond(h: CompiledHierarchy, r: torch.Tensor) -> torch.Tensor:
    return vcycle(h, r, torch.zeros_like(r))


def vcycle_apply(h: CompiledHierarchy, b: torch.Tensor,
                 graph: bool = True) -> torch.Tensor:
    """One preconditioner application; on the card a replay of the
    hierarchy's captured V-cycle graph unless ``graph=False``
    (solve/device_pcg.py)."""
    return graphed(h, lambda r: precond(h, r), b, graph)


def pcg_solve(h: CompiledHierarchy, b: torch.Tensor,
              x0: Optional[torch.Tensor] = None, rel_tol: float = 1e-6,
              abs_tol: float = 0.0, max_iter: int = 200, graph: bool = True):
    """PCG (solve/device_pcg.py) preconditioned by one V-cycle, with the
    finest operator; returns (x, iterations, final (B r, r)).  On the
    card the prologue and each iteration replay captured CUDA graphs
    unless ``graph=False`` asks for the eager loop."""
    return pcg(h, h.levels[0].matvec, lambda r: precond(h, r), b, x0=x0,
               rel_tol=rel_tol, abs_tol=abs_tol, max_iter=max_iter,
               graph=graph)
