"""Smoother sweeps: k chained stencil roots, optionally followed by the
residual, in one call.

The wrapper ``wavefront_smooth`` launches the cooperative kernel
(csrc/wavefront.cu, replacing saamge_tpu/ops/pallas_wavefront.py
`_build_sweep`) for CUDA tensors; its plain version IS the chain of
plain stencil passes, and runs for CPU tensors.  The kernel runs one
level (a root, or the trailing residual) at a time, a grid barrier
between levels."""

from __future__ import annotations

import ctypes

import torch

from saamge_tpu_torch._device import is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.stencil import _check_operands, stencil_plain_h
from saamge_tpu_torch.utils.logging import TIMERS


def wavefront_plain(A: DIA, inv_taus, bh, dinvh, xh,
                    emit_residual: bool = False):
    for it in inv_taus:
        xh = stencil_plain_h("root", A, xh, bh, dinvh, it)
    if emit_residual:
        return xh, stencil_plain_h("residual", A, xh, bh)
    return xh


def launch_sweep(A: DIA, inv_taus, bh, dinvh, xh, emit_residual: bool,
                 what: str):
    """One launch of csrc/wavefront.cu on card tensors (at most
    MAX_ROOTS roots); returns (out, res or None)."""
    _check_operands(A, {"x": xh, "b": bh, "dinv": dinvh})
    lib = _build.load()
    out = torch.empty_like(xh)
    tmp = torch.empty_like(xh)
    res = torch.empty_like(xh) if emit_residual else None
    offs = _build.int_array(A.offsets)
    taus = _build.float_array(inv_taus)
    with torch.cuda.device(xh.device):
        code = lib.saamge_wavefront(
            A.vals.data_ptr(), int(A.vals.dtype == torch.bfloat16),
            ctypes.addressof(offs), len(A.offsets), A.n, A.halo,
            ctypes.addressof(taus), len(inv_taus), int(emit_residual),
            bh.data_ptr(), dinvh.data_ptr(), xh.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), res.data_ptr() if res is not None else None,
            _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, what)
    return out, res


def wavefront_smooth(A: DIA, inv_taus, bh, dinvh, xh,
                     emit_residual: bool = False):
    """Roots x <- x + dinv (b - A x) * inv_tau_r over haloed vectors;
    returns xh' or (xh', resh) with ``emit_residual``."""
    if not 1 <= len(inv_taus) <= _build.MAX_ROOTS:
        raise ValueError(f"{len(inv_taus)} roots: expected "
                         f"1..{_build.MAX_ROOTS}")
    if not is_cuda(A.vals, xh, bh, dinvh):
        return wavefront_plain(A, inv_taus, bh, dinvh, xh, emit_residual)
    out, res = launch_sweep(A, inv_taus, bh, dinvh, xh, emit_residual,
                            "wavefront")
    TIMERS.count("wavefront.kernel")
    return (out, res) if emit_residual else out
