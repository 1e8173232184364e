"""DIA stencil passes on haloed vectors: ``y = A x``, ``y = b - A x`` and
the smoother root ``y = x + dinv (b - A x) / tau``.

The wrapper ``stencil_h`` launches the hand-written kernel
(csrc/stencil.cu, replacing saamge_tpu/ops/pallas_stencil.py `_build`)
for CUDA tensors and runs the plain torch version ``stencil_plain_h``
for CPU tensors.  Every vector is haloed (see ops/sparse.DIA) and the
output's halo is zero, so passes chain without glue."""

from __future__ import annotations

import ctypes

import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.sparse import DIA, dia_apply_h
from saamge_tpu_torch.utils.logging import TIMERS

MODES = {"spmv": 0, "residual": 1, "root": 2}


def stencil_plain_h(mode: str, A: DIA, xh, bh=None, dinvh=None,
                    inv_tau: float = 0.0) -> torch.Tensor:
    ax = dia_apply_h(A, xh)
    h = A.halo
    if mode == "spmv":
        y = ax
    elif mode == "residual":
        y = bh[h:h + A.n] - ax
    elif mode == "root":
        y = xh[h:h + A.n] + dinvh[h:h + A.n] * (bh[h:h + A.n] - ax) \
            * inv_tau
    else:
        raise ValueError(mode)
    return A.pad(y)


def _check_operands(A: DIA, vecs) -> None:
    check(A.vals, "vals", (torch.float32, torch.bfloat16),
          (len(A.offsets), A.n))
    for name, v in vecs.items():
        check(v, name, torch.float32, (A.n + 2 * A.halo,))


def stencil_h(mode: str, A: DIA, xh, bh=None, dinvh=None,
              inv_tau: float = 0.0) -> torch.Tensor:
    """One stencil pass in ``mode`` ('spmv', 'residual' or 'root')."""
    vecs = {"x": xh}
    if mode in ("residual", "root"):
        vecs["b"] = bh
    if mode == "root":
        vecs["dinv"] = dinvh
    if mode not in MODES:
        raise ValueError(mode)
    if not is_cuda(A.vals, *vecs.values()):
        return stencil_plain_h(mode, A, xh, bh, dinvh, inv_tau)
    _check_operands(A, vecs)
    lib = _build.load()
    y = torch.empty_like(xh)
    offs = _build.int_array(A.offsets)
    with torch.cuda.device(xh.device):
        code = lib.saamge_stencil(
            MODES[mode], A.vals.data_ptr(),
            int(A.vals.dtype == torch.bfloat16), ctypes.addressof(offs),
            len(A.offsets), A.n, A.halo, xh.data_ptr(),
            vecs["b"].data_ptr() if "b" in vecs else None,
            vecs["dinv"].data_ptr() if "dinv" in vecs else None,
            float(inv_tau), y.data_ptr(), _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, "stencil")
    TIMERS.count("stencil.kernel")
    return y

