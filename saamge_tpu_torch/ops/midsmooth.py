"""Mid-level smoothing chains on the brick-block operator.

The operator lives in the slot-major padded layout (coarse dof (brick p,
slot s) at ``s * NB + p``) as ``blocks[k, s1, s2, p] = A1[(p, s1),
(p + doffs[k], s2)]`` over <= 27 brick offsets, with per-offset used-slot
rectangles ``rects[k] = (r1, r2)`` outside which a block is zero.

``brick_block_matvec`` is the plain matvec (the port of
BrickBlockOp.matvec).  ``mid_chain`` runs k roots
``x <- x + d (b - A1 x) * inv_tau_r`` and optionally the trailing
residual: for CUDA tensors as one launch of the cooperative kernel of
csrc/midsmooth.cu (replacing saamge_tpu/ops/pallas_midsmooth.py
`_build_mid_chain`), for CPU tensors as the chain of plain matvecs.
Both widen bf16 blocks to f32 and multiply in f32."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build

MAX_OFFSETS = 27        # SAAMGE_MAX_BOFFS of csrc/common.cuh


def brick_block_matvec(blocks, doffs, bricks, x) -> torch.Tensor:
    """y = A1 x on slot-major flat (bs * NB,) vectors (plain torch)."""
    BX, BY, BZ = bricks
    bs, NB = blocks.shape[1], blocks.shape[3]
    xp = F.pad(x.to(torch.float32).view(bs, BX, BY, BZ), (1, 1, 1, 1, 1, 1))
    y = torch.zeros(bs, NB, dtype=torch.float32, device=x.device)
    for k, (dx, dy, dz) in enumerate(doffs):
        view = xp[:, 1 + dx:1 + dx + BX, 1 + dy:1 + dy + BY,
                  1 + dz:1 + dz + BZ].reshape(bs, NB)
        y += (blocks[k].to(torch.float32) * view[None]).sum(1)
    return y.reshape(-1)


def mid_chain_plain(blocks, doffs, bricks, inv_taus, b, d, x,
                    emit_res: bool = False):
    for it in inv_taus:
        x = x + d * (b - brick_block_matvec(blocks, doffs, bricks, x)) * it
    if emit_res:
        return x, b - brick_block_matvec(blocks, doffs, bricks, x)
    return x


def mid_chain(blocks, doffs, rects, bricks, inv_taus, b, d, x,
              emit_res: bool = False):
    """All roots of one mid smoothing chain on flat (bs * NB,) vectors;
    returns x' or (x', b - A1 x')."""
    if not 1 <= len(inv_taus) <= _build.MAX_ROOTS:
        raise ValueError(f"{len(inv_taus)} roots: expected "
                         f"1..{_build.MAX_ROOTS}")
    if not is_cuda(blocks, b, d, x):
        return mid_chain_plain(blocks, doffs, bricks, inv_taus, b, d, x,
                               emit_res)
    kd, bs, _, NB = blocks.shape
    if not 1 <= kd <= MAX_OFFSETS or len(doffs) != kd or len(rects) != kd:
        raise ValueError(f"{kd} block offsets, {len(doffs)} doffs, "
                         f"{len(rects)} rects")
    if bricks[0] * bricks[1] * bricks[2] != NB:
        raise ValueError(f"bricks {bricks} do not match NB={NB}")
    check(blocks, "blocks", (torch.float32, torch.bfloat16), (kd, bs, bs, NB))
    for name, v in (("b", b), ("d", d), ("x", x)):
        check(v, name, torch.float32, (bs * NB,))
    geom = list(bricks) + [bs]
    for (dx, dy, dz), (r1, r2) in zip(doffs, rects):
        geom += [dx, dy, dz, r1, r2]
    geom = _build.int_array(geom)
    taus = _build.float_array(inv_taus)
    lib = _build.load()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    res = torch.empty_like(x) if emit_res else None
    with torch.cuda.device(x.device):
        code = lib.saamge_mid_chain(
            blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
            ctypes.addressof(geom), kd, ctypes.addressof(taus),
            len(inv_taus), int(emit_res), b.data_ptr(), d.data_ptr(),
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            res.data_ptr() if res is not None else None,
            _build.stream_ptr(x.device))
    _build.check_launch(lib, code, "mid_chain")
    mid_chain.launches += 1
    return (out, res) if emit_res else out


mid_chain.launches = 0
