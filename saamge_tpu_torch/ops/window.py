"""Tent restriction R and prolongation P between the fine node grid and
the slot-major padded coarse layout (coarse dof (brick p, slot s) at
``s * NB + p``), with ``Rst`` the (bs, box, NB) tent blocks:

    R:  yc[s, p] = sum_w Rst[s, w, p] * r[window(p, w)]
    P:  the adjoint, summing the planes that neighbouring bricks share.

The wrappers launch the kernels of csrc/window.cu (replacing
saamge_tpu/ops/pallas_window.py `_build_window_R` / `_build_window_P`)
for CUDA tensors and run the plain versions for CPU tensors.  Both read
Rst widened to f32 and keep r, xc and all sums in f32: the numerics of
the JAX package's XLA apply_R / apply_P with a bf16 Rst, not of its
window kernels, whose selection matmuls truncate to bf16.

Window R's launch plan is ``window_R_plan``: a block stages the node
slab of one z-line of bricks in shared memory and sums four slots of
them (csrc/window.cu).  Window P reads, for each brick and box node,
only the slots of ``slot_ranges``: the tent's nonzeros.  The ctypes
geometry and plan are built once per (bricks, brick_elems, bs)."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.utils.logging import TIMERS


def _dims(bricks, brick_elems):
    nodes = tuple(B * b + 1 for B, b in zip(bricks, brick_elems))
    box = 1
    for b in brick_elems:
        box *= b + 1
    NB = bricks[0] * bricks[1] * bricks[2]
    return nodes, box, NB


def box_index(bricks, brick_elems, device) -> torch.Tensor:
    """(box, NB) fine-node ids of every brick's closed box:
    idx[(u*(by+1)+v)*(bz+1)+w, p] = node (px*bx+u, py*by+v, pz*bz+w)."""
    nodes, box, NB = _dims(bricks, brick_elems)
    bx, by, bz = brick_elems
    ids = torch.arange(nodes[0] * nodes[1] * nodes[2],
                       device=device).view(nodes)
    win = ids.unfold(0, bx + 1, bx).unfold(1, by + 1, by) \
        .unfold(2, bz + 1, bz)          # (BX, BY, BZ, bx+1, by+1, bz+1)
    return win.permute(3, 4, 5, 0, 1, 2).reshape(box, NB)


def window_R_plain(Rst, r, bricks, brick_elems) -> torch.Tensor:
    idx = box_index(bricks, brick_elems, r.device)
    boxes = r.to(torch.float32)[idx]                       # (box, NB)
    return (Rst.to(torch.float32) * boxes[None]).sum(1).reshape(-1)


def window_P_plain(Rst, xc, bricks, brick_elems) -> torch.Tensor:
    nodes, box, NB = _dims(bricks, brick_elems)
    bs = Rst.shape[0]
    C = (Rst.to(torch.float32)
         * xc.to(torch.float32).view(bs, 1, NB)).sum(0)   # (box, NB)
    idx = box_index(bricks, brick_elems, xc.device)
    y = torch.zeros(nodes[0] * nodes[1] * nodes[2], dtype=torch.float32,
                    device=xc.device)
    return y.index_add_(0, idx.reshape(-1), C.reshape(-1))


SLOTS_PER_BLOCK = 4          # WINDOW_R_SG of csrc/window.cu
V_SPLITS = 3                 # window R: threads per box (u) plane's rows
MAX_THREADS = 256            # WINDOW_R_THREADS: its launch bound


class WindowRPlan(NamedTuple):
    """Launch of csrc/window.cu's window R: block (tx, g) stages the
    nodes of brick z-line tx (bricks tx * BZ .. tx * BZ + BZ - 1), rows
    of ``pitch`` floats, and sums slots 4 g .. 4 g + 3 of its bricks; a
    thread takes one box x-plane, one of ``vs`` ranges of its rows and
    one brick pair."""
    threads: int
    grid: Tuple[int, int]
    smem: int
    vs: int
    pitch: int

    def ints(self):
        return (self.threads, *self.grid, self.smem, self.vs, self.pitch)

    def block_outputs(self, bricks, bs: int, tx: int, g: int) -> np.ndarray:
        """Flat output indices ``s * NB + p`` that block (tx, g) writes,
        as the kernel computes them."""
        BZ, NB = bricks[2], int(np.prod(bricks))
        p = tx * BZ + np.arange(BZ)
        s = np.arange(g * SLOTS_PER_BLOCK,
                      min((g + 1) * SLOTS_PER_BLOCK, bs))
        return (s[:, None] * NB + p[None]).reshape(-1)


def window_R_plan(bricks, brick_elems, bs: int) -> WindowRPlan:
    """The slab is (bx+1) x (by+1) node rows of one z-line, each of
    ``pitch`` = BZ (bz+1) + 1 floats (node gz at gz + gz // bz); the
    partial sums are 4 slots x (bx+1) x vs x (2 * brick pairs).  Raises
    when they exceed a block's shared memory."""
    BX, BY, BZ = bricks
    bx, by, bz = brick_elems
    vs = min(V_SPLITS, by + 1)
    pairs = (BZ + 1) // 2
    pitch = BZ * (bz + 1) + 1
    smem = 4 * ((bx + 1) * (by + 1) * pitch
                + SLOTS_PER_BLOCK * (bx + 1) * vs * 2 * pairs)
    if smem > _build.SMEM_MAX:
        raise ValueError(f"window R: the node slab of bricks {bricks} x "
                         f"{brick_elems} exceeds {_build.SMEM_MAX} shared "
                         "bytes")
    items = (bx + 1) * vs * pairs
    plan = WindowRPlan(threads=min(MAX_THREADS, -(-items // 32) * 32),
                       grid=(BX * BY, -(-bs // SLOTS_PER_BLOCK)),
                       smem=smem, vs=vs, pitch=pitch)
    _build.check_plan(plan.threads, plan.grid, plan.smem)
    return plan


def _check_Rst(Rst, bricks, brick_elems):
    nodes, box, NB = _dims(bricks, brick_elems)
    check(Rst, "Rst", (torch.float32, torch.bfloat16),
          (Rst.shape[0], box, NB))
    return nodes, NB


@functools.lru_cache(maxsize=32)
def _geom(bricks, brick_elems, bs: int):
    return _build.int_array(list(bricks) + list(brick_elems) + [bs])


@functools.lru_cache(maxsize=32)
def _R_plan(bricks, brick_elems, bs: int):
    return _build.int_array(window_R_plan(bricks, brick_elems, bs).ints())


def window_R(Rst, r, bricks, brick_elems) -> torch.Tensor:
    """Fine (n,) vector on the node grid -> (bs * NB,) coarse values."""
    if not is_cuda(Rst, r):
        return window_R_plain(Rst, r, bricks, brick_elems)
    nodes, NB = _check_Rst(Rst, bricks, brick_elems)
    check(r, "r", torch.float32, (nodes[0] * nodes[1] * nodes[2],))
    bs = Rst.shape[0]
    geom, plan = _geom(bricks, brick_elems, bs), _R_plan(bricks,
                                                         brick_elems, bs)
    lib = _build.load()
    yc = torch.empty(bs * NB, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = lib.saamge_window_R(
            int(Rst.dtype == torch.bfloat16), Rst.data_ptr(),
            ctypes.addressof(geom), ctypes.addressof(plan), r.data_ptr(),
            yc.data_ptr(), _build.stream_ptr(r.device))
    _build.check_launch(lib, code, "window_R")
    TIMERS.count("window.kernel.R")
    return yc


def slot_ranges(Rst) -> torch.Tensor:
    """(2, box, NB) uint8 table of the nonzero slots of each tent column:
    ``[0, w, p]`` is the first slot s with Rst[s, w, p] != 0 and ``[1, w,
    p]`` one past the last, both 0 where the column is all zero.  The
    coarse dofs of one MIS hold consecutive slots of its master brick and
    a node lies in one MIS, so for the tent of the setup each range holds
    one MIS's slots; for any Rst it covers every nonzero (a dense one
    gives [0, bs) everywhere)."""
    bs = Rst.shape[0]
    if bs > 255:
        raise ValueError(f"{bs} slots per brick: the uint8 slot table "
                         "holds at most 255")
    nz = (Rst != 0).to(torch.uint8)
    lo = nz.argmax(0)                           # the first maximum
    hi = bs - nz.flip(0).argmax(0)
    empty = nz.amax(0) == 0
    return torch.stack([lo.masked_fill(empty, 0),
                        hi.masked_fill(empty, 0)]).to(torch.uint8)


def window_P(Rst, xc, bricks, brick_elems, ranges=None) -> torch.Tensor:
    """(bs * NB,) coarse values -> fine (n,) vector on the node grid.
    On the card ``ranges`` (``slot_ranges(Rst)``) is required: the kernel
    reads only the slots inside them; the plain version ignores it."""
    if not is_cuda(Rst, xc):
        return window_P_plain(Rst, xc, bricks, brick_elems)
    nodes, NB = _check_Rst(Rst, bricks, brick_elems)
    check(xc, "xc", torch.float32, (Rst.shape[0] * NB,))
    if ranges is None:
        raise ValueError("window_P on the card needs the slot ranges of "
                         "Rst (slot_ranges)")
    check(ranges, "ranges", torch.uint8, (2,) + tuple(Rst.shape[1:]))
    if ranges.device != xc.device:
        raise ValueError(f"ranges on {ranges.device}, xc on {xc.device}")
    geom = _geom(bricks, brick_elems, Rst.shape[0])
    lib = _build.load()
    y = torch.empty(nodes[0] * nodes[1] * nodes[2], dtype=torch.float32,
                    device=xc.device)
    with torch.cuda.device(xc.device):
        code = lib.saamge_window_P(
            int(Rst.dtype == torch.bfloat16), Rst.data_ptr(),
            ranges.data_ptr(), ctypes.addressof(geom), xc.data_ptr(),
            y.data_ptr(), _build.stream_ptr(xc.device))
    _build.check_launch(lib, code, "window_P")
    TIMERS.count("window.kernel.P")
    return y
