"""One pass of the mid level's brick-block operator over packed
used-slot rectangles, in three modes (those of ops/stencil.py):

    spmv      y = A1 x
    residual  y = b - A1 x
    root      y = x + dinv * (b - A1 x) * inv_tau

in the op order of the JAX chain ``x1 + dinv1 * (b1 - A x1) * it``
(saamge_tpu/solve/structured.py mid_correct).

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
ported.  The kernel's launch plan is ``midmv_plan``; the ctypes geometry
and plan of an operator are built once and memoised on
(doffs, rects, bricks, bs).  The counters ``midmv.kernel`` (a launch of
csrc/midmv.cu, and ``midmv.kernel.<mode>`` by mode) and ``midmv.plain``
(a pass on the plain route) of utils/logging.TIMERS count each call."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.midsmooth import MAX_OFFSETS
from saamge_tpu_torch.utils.logging import TIMERS

MODES = {"spmv": 0, "residual": 1, "root": 2}
TILE = 64             # MIDMV_TILE of csrc/midmv.cu: bricks per block
SLOTS = 5             # MIDMV_SLOTS: output slots per block
TASK = 4              # MIDMV_TASK: rows of one offset a warp takes at once
WARPS = 16            # warps per block, splitting the tasks


class MidmvPlan(NamedTuple):
    """Launch of csrc/midmv.cu: block (tx, g) computes output slots
    g * SLOTS .. g * SLOTS + SLOTS - 1 of bricks [tx * TILE, (tx + 1) *
    TILE) of the NB."""
    threads: int
    grid: Tuple[int, int]
    smem: int

    def ints(self):
        return (self.threads, *self.grid, self.smem)

    def block_outputs(self, NB: int, bs: int, tx: int, g: int) -> np.ndarray:
        """Flat output indices ``s * NB + p`` that block (tx, g) writes,
        as the kernel computes them."""
        p = np.arange(tx * TILE, min((tx + 1) * TILE, NB))
        s = np.arange(g * SLOTS, min((g + 1) * SLOTS, bs))
        return (s[:, None] * NB + p[None]).reshape(-1)


def midmv_plan(bricks, bs: int, rects) -> MidmvPlan:
    """Shared bytes: the block's task list (at most sum_k ceil(r2_k /
    TASK) tasks) and the warps' partial sums (SLOTS x TILE each)."""
    NB = int(np.prod(bricks))
    tasks = sum(-(-r2 // TASK) for _, r2 in rects)
    plan = MidmvPlan(threads=32 * WARPS,
                     grid=(-(-NB // TILE), -(-int(bs) // SLOTS)),
                     smem=4 * (tasks + WARPS * SLOTS * TILE))
    _build.check_plan(plan.threads, plan.grid, plan.smem)
    return plan


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


def midmv_plain(packed, doffs, rects, bricks, bs: int, x, mode="spmv",
                b=None, dinv=None, inv_tau: float = 0.0) -> torch.Tensor:
    """One pass in ``mode`` on slot-major flat (bs * NB,) vectors (plain
    torch)."""
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
    ax = y.reshape(-1)
    if mode == "spmv":
        return ax
    if mode == "residual":
        return b - ax
    if mode == "root":
        return x + dinv * (b - ax) * inv_tau
    raise ValueError(mode)


@functools.lru_cache(maxsize=32)
def _launch_args(doffs, rects, bricks, bs: int):
    """(ctypes geometry, ctypes plan, packed length) of one operator,
    checked once: BX, BY, BZ, bs, then per offset (dx, dy, dz, r1, r2)."""
    kd = len(doffs)
    if not 1 <= kd <= MAX_OFFSETS or len(rects) != kd:
        raise ValueError(f"{kd} block offsets, {len(rects)} rects")
    if any(not (0 <= r <= bs) for rect in rects for r in rect):
        raise ValueError(f"rects {rects} exceed bs={bs}")
    NB = bricks[0] * bricks[1] * bricks[2]
    geom = list(bricks) + [bs]
    for (dx, dy, dz), (r1, r2) in zip(doffs, rects):
        geom += [dx, dy, dz, r1, r2]
    plan = midmv_plan(bricks, bs, rects)
    return (_build.int_array(geom), _build.int_array(plan.ints()),
            packed_starts(rects, NB)[1])


def midmv(packed, doffs, rects, bricks, bs: int, x, mode="spmv", b=None,
          dinv=None, inv_tau: float = 0.0) -> torch.Tensor:
    """One pass in ``mode`` ('spmv', 'residual' or 'root'): the kernel for
    CUDA tensors, the plain version for CPU tensors.  ``doffs``,
    ``rects`` and ``bricks`` are tuples (the memo's key)."""
    if mode not in MODES:
        raise ValueError(mode)
    vecs = {"x": x}
    if mode != "spmv":
        vecs["b"] = b
    if mode == "root":
        vecs["dinv"] = dinv
    if not is_cuda(packed, *vecs.values()):
        TIMERS.count("midmv.plain")
        return midmv_plain(packed, doffs, rects, bricks, bs, x, mode, b,
                           dinv, inv_tau)
    geom, plan, total = _launch_args(doffs, rects, bricks, bs)
    check(packed, "packed", (torch.float32, torch.bfloat16), (total,))
    for name, v in vecs.items():
        check(v, name, torch.float32,
              (bs * bricks[0] * bricks[1] * bricks[2],))
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.saamge_midmv(
            MODES[mode], packed.data_ptr(),
            int(packed.dtype == torch.bfloat16), ctypes.addressof(geom),
            len(doffs), ctypes.addressof(plan), x.data_ptr(),
            b.data_ptr() if "b" in vecs else None,
            dinv.data_ptr() if "dinv" in vecs else None, float(inv_tau),
            y.data_ptr(), _build.stream_ptr(x.device))
    _build.check_launch(lib, code, "midmv")
    TIMERS.count("midmv.kernel")
    TIMERS.count("midmv.kernel." + mode)
    return y
