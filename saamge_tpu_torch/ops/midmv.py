"""One mid-level brick-block matvec over packed used-slot rectangles.

The mid operator is the one of ops/midsmooth.py (slot-major padded
layout, coarse dof (brick p, slot s) at ``s * NB + p``; brick offsets
``doffs`` with used-slot rectangles ``rects``), stored without its
structurally zero slot pairs: ``pack_blocks`` keeps, per offset k, only
``blocks[k, :r1_k, :r2_k, :]``, one after another in one flat buffer.
The offset table is ``packed_starts(rects, NB)``.  Packing is numpy on
the host, so the full (k, bs, bs, NB) blocks never reach the device.

``midmv`` launches the hand-written kernel (csrc/midmv.cu, replacing
saamge_tpu/ops/pallas_midmv.py `_build_chunked_mv`) for CUDA tensors and
runs ``midmv_plain`` for CPU tensors.  Both widen bf16 blocks to f32 and
multiply by the f32 x in f32; the TPU kernel rounds x and each product
to bf16.  Its lane chunking (``chunk_plan``) is a VMEM budget and is not
ported."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.midsmooth import MAX_OFFSETS


def packed_starts(rects, NB: int):
    """Start of each offset's (r1, r2, NB) rectangle in the packed
    buffer, and the buffer's length."""
    sizes = [r1 * r2 * NB for r1, r2 in rects]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    return tuple(int(s) for s in starts[:-1]), int(starts[-1])


def pack_blocks(blocks: np.ndarray, rects, dtype) -> torch.Tensor:
    """Host (k, bs, bs, NB) blocks -> the flat packed buffer in
    ``dtype`` (rounded to f32 first, as the JAX package's arrays are)."""
    parts = [np.ascontiguousarray(blocks[k, :r1, :r2, :], np.float32)
             .reshape(-1) for k, (r1, r2) in enumerate(rects)]
    return torch.as_tensor(np.concatenate(parts)).to(dtype)


def midmv_plain(packed, doffs, rects, bricks, bs: int, x) -> torch.Tensor:
    """y = A1 x on slot-major flat (bs * NB,) vectors (plain torch)."""
    BX, BY, BZ = bricks
    NB = BX * BY * BZ
    starts, _ = packed_starts(rects, NB)
    xp = F.pad(x.to(torch.float32).view(bs, BX, BY, BZ), (1, 1, 1, 1, 1, 1))
    y = torch.zeros(bs, NB, dtype=torch.float32, device=x.device)
    for k, ((dx, dy, dz), (r1, r2)) in enumerate(zip(doffs, rects)):
        B = packed[starts[k]:starts[k] + r1 * r2 * NB].view(r1, r2, NB)
        view = xp[:r2, 1 + dx:1 + dx + BX, 1 + dy:1 + dy + BY,
                  1 + dz:1 + dz + BZ].reshape(r2, NB)
        y[:r1] += (B.to(torch.float32) * view[None]).sum(1)
    return y.reshape(-1)


def midmv(packed, doffs, rects, bricks, bs: int, x) -> torch.Tensor:
    """y = A1 x: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not is_cuda(packed, x):
        return midmv_plain(packed, doffs, rects, bricks, bs, x)
    kd = len(doffs)
    if not 1 <= kd <= MAX_OFFSETS or len(rects) != kd:
        raise ValueError(f"{kd} block offsets, {len(rects)} rects")
    NB = bricks[0] * bricks[1] * bricks[2]
    if any(not (0 <= r <= bs) for rect in rects for r in rect):
        raise ValueError(f"rects {rects} exceed bs={bs}")
    check(packed, "packed", (torch.float32, torch.bfloat16),
          (packed_starts(rects, NB)[1],))
    check(x, "x", torch.float32, (bs * NB,))
    geom = list(bricks) + [bs]
    for (dx, dy, dz), (r1, r2) in zip(doffs, rects):
        geom += [dx, dy, dz, r1, r2]
    geom = _build.int_array(geom)
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.saamge_midmv(
            packed.data_ptr(), int(packed.dtype == torch.bfloat16),
            ctypes.addressof(geom), kd, x.data_ptr(), y.data_ptr(),
            _build.stream_ptr(x.device))
    _build.check_launch(lib, code, "midmv")
    midmv.launches += 1
    return y


midmv.launches = 0
