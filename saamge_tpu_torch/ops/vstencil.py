"""Products of the node-block stencil format (ops/sparse.NodeBlock: a
vector field of 3 dofs a node, 27 node offsets of dense 3 x 3 blocks) on
haloed vectors, in three modes:

    spmv      y = A x
    residual  y = b - A x
    chain     all roots x <- x + dinv (b - A x) / tau, and with
              ``emit_residual`` the trailing residual b - A x

The wrapper ``vstencil`` launches the hand-written kernel
(csrc/vstencil.cu: one launch a pass, one cooperative launch a chain of
at most MAX_ROOTS roots) for CUDA tensors, and raises unless the values
are f32 in 3 x 3 blocks; for CPU tensors it runs ``vstencil_plain``,
the same sums in the same order in plain torch.  The counters
``vstencil.kernel`` and ``vstencil.kernel.<mode>`` of
utils/logging.TIMERS count the launches, ``vstencil.plain`` the calls
that take the plain route."""

from __future__ import annotations

import ctypes

import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.sparse import NodeBlock
from saamge_tpu_torch.utils.logging import TIMERS

MODES = {"spmv": 0, "residual": 1, "chain": 2}


def node_block_apply_h(A: NodeBlock, xh: torch.Tensor) -> torch.Tensor:
    """(A x) on the n rows, from a haloed x (plain torch): each row sums
    over the node offsets in order and, in each, over the block's
    columns in order, every product rounded before its sum (the
    kernel's order); in f32 for f32 values, f64 for f64 ones."""
    bs, N, H = A.bs, A.nodes, A.halo
    dt = torch.promote_types(torch.promote_types(A.vals.dtype, xh.dtype),
                             torch.float32)
    X = xh.to(dt).view(-1, bs)
    xk = torch.stack([X[H + off:H + off + N].T for off in A.offsets])
    prod = A.vals.to(dt) * xk[:, None]          # (K, bs, bs, N) products
    acc = torch.zeros(bs, N, dtype=dt, device=xh.device)
    for k in range(len(A.offsets)):
        for c in range(bs):
            acc = acc + prod[k, :, c]
    return acc.T.reshape(-1)


def vstencil_plain(A: NodeBlock, mode: str, xh, bh=None, dinvh=None,
                   inv_taus=(), emit_residual: bool = False):
    """``vstencil`` in plain torch (any device and dtype)."""
    h, n = A.bs * A.halo, A.n

    def inner(v):
        return v[h:h + n]

    def pad(y):
        return torch.nn.functional.pad(y, (h, h))

    if mode == "spmv":
        return pad(node_block_apply_h(A, xh))
    if mode == "residual":
        return pad(inner(bh) - node_block_apply_h(A, xh))
    if mode != "chain":
        raise ValueError(mode)
    for it in inv_taus:
        xh = pad(inner(xh) + inner(dinvh) * (inner(bh)
                                             - node_block_apply_h(A, xh))
                 * it)
    if emit_residual:
        return xh, pad(inner(bh) - node_block_apply_h(A, xh))
    return xh


def _launch(lib, A, mode, xh, bh, dinvh, taus, emit_residual, out, tmp,
            res, offs):
    with torch.cuda.device(xh.device):
        code = lib.saamge_vstencil(
            MODES[mode], A.vals.data_ptr(), ctypes.addressof(offs),
            len(A.offsets), A.nodes, A.halo, ctypes.addressof(taus),
            len(taus) if mode == "chain" else 0, int(emit_residual),
            bh.data_ptr() if bh is not None else None,
            dinvh.data_ptr() if dinvh is not None else None,
            xh.data_ptr(), out.data_ptr(),
            tmp.data_ptr() if tmp is not None else None,
            res.data_ptr() if res is not None else None,
            _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, "vstencil")
    TIMERS.count("vstencil.kernel")
    TIMERS.count("vstencil.kernel." + mode)


def vstencil(A: NodeBlock, mode: str, xh, bh=None, dinvh=None,
             inv_taus=(), emit_residual: bool = False):
    """One pass ('spmv', 'residual') or one smoothing chain ('chain') of
    ``A`` over haloed vectors; the chain returns xh' or, with
    ``emit_residual``, (xh', resh).  More than MAX_ROOTS roots run as
    consecutive launches, the last one emitting the residual."""
    if mode not in MODES:
        raise ValueError(mode)
    vecs = {"x": xh}
    if mode in ("residual", "chain"):
        vecs["b"] = bh
    if mode == "chain":
        if not inv_taus:
            raise ValueError("no roots")
        vecs["dinv"] = dinvh
    if not is_cuda(A.vals, *vecs.values()):
        TIMERS.count("vstencil.plain")
        return vstencil_plain(A, mode, xh, bh, dinvh, inv_taus,
                              emit_residual)
    check(A.vals, "vals", torch.float32,
          (len(A.offsets), 3, 3, A.nodes))
    for name, v in vecs.items():
        check(v, name, torch.float32, (3 * (A.nodes + 2 * A.halo),))
    lib = _build.load()
    offs = _build.int_array(A.offsets)
    if mode != "chain":
        y = torch.empty_like(xh)
        _launch(lib, A, mode, xh, bh, None, _build.float_array(()), False,
                y, None, None, offs)
        return y
    res = None
    chunks = [inv_taus[i:i + _build.MAX_ROOTS]
              for i in range(0, len(inv_taus), _build.MAX_ROOTS)]
    for j, chunk in enumerate(chunks):
        emit = emit_residual and j == len(chunks) - 1
        out, tmp = torch.empty_like(xh), torch.empty_like(xh)
        res = torch.empty_like(xh) if emit else None
        _launch(lib, A, mode, xh, bh, dinvh, _build.float_array(chunk),
                emit, out, tmp, res, offs)
        xh = out
    return (xh, res) if emit_residual else xh
