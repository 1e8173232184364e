"""Fused polynomial smoother of the general path: every root
x <- x + dinv (b - A x) / tau of an f32 DIA operator in one launch.

Replaces saamge_tpu/ops/pallas_smoother.py `_build` (the VMEM-resident
fused smoother).  On the card the wrapper ``smoother_h`` runs the device
code of the cooperative sweep (csrc/wavefront.cu: chained roots over
haloed diagonals, a grid barrier between roots) with f32 values and all
roots, under its own launch counter (``smoother.kernel``, one a launch
of at most MAX_ROOTS roots) so that a run can tell the general path's
smoother from the structured sweep.  Its plain version is the chain of
plain stencil root passes, run for CPU tensors.

The TPU kernel exists because a small operator fits in VMEM: its
``fits_vmem`` gate ((k + 5) n_pad 4 B <= 10 MiB) is a TPU budget, and
above it the JAX general path runs the same roots as blocked stencil
passes.  The cooperative sweep has no on-chip budget to fit, so the port
drops the gate: every f32 DIA level without a second root chain smooths
through this one kernel, and the pre-smoothing launch also emits the
residual (``emit_residual``), as the structured path's sweep does.

Bound on this card: device-memory bytes (each root re-reads the k x n
f32 diagonals; for the operators of the general path that fit the 50 MB
L2 the re-reads are served from it)."""

from __future__ import annotations

import numpy as np
import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.wavefront import launch_sweep, wavefront_plain
from saamge_tpu_torch.utils.logging import TIMERS


def smoother_plain(A: DIA, inv_taus, bh, dinvh, xh,
                   emit_residual: bool = False):
    return wavefront_plain(A, inv_taus, bh, dinvh, xh, emit_residual)


def smoother_h(A: DIA, inv_taus, bh, dinvh, xh,
               emit_residual: bool = False):
    """All roots (+ the trailing residual b - A x) over haloed f32
    vectors; returns xh' or (xh', resh) with ``emit_residual``.  More
    than MAX_ROOTS roots run as consecutive launches."""
    if not inv_taus:
        raise ValueError("no roots")
    if not is_cuda(A.vals, xh, bh, dinvh):
        return smoother_plain(A, inv_taus, bh, dinvh, xh, emit_residual)
    check(A.vals, "vals", torch.float32, (len(A.offsets), A.n))
    res = None
    chunks = [inv_taus[i:i + _build.MAX_ROOTS]
              for i in range(0, len(inv_taus), _build.MAX_ROOTS)]
    for j, chunk in enumerate(chunks):
        last = j == len(chunks) - 1
        xh, res = launch_sweep(A, chunk, bh, dinvh, xh,
                               emit_residual and last, "smoother")
        TIMERS.count("smoother.kernel")
    return (xh, res) if emit_residual else xh


def inv_taus_f32(roots) -> tuple:
    """1/tau of each root, rounded to f32 (the constants the JAX fused
    and blocked smoothers multiply by)."""
    return tuple(float(np.float32(1.0 / float(t)))
                 for t in np.asarray(roots))


def fused_dia_smoother(A: DIA, dinv: torch.Tensor, roots):
    """Returns smoother(b, x) -> x on flat vectors, all ``roots``
    applied in one launch (the JAX fused_dia_smoother's interface)."""
    dinvh = A.pad(dinv)
    inv_taus = inv_taus_f32(roots)

    def smoother(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        xh = smoother_h(A, inv_taus, A.pad(b), dinvh, A.pad(x))
        return A.unpad(xh).to(x.dtype)

    return smoother
