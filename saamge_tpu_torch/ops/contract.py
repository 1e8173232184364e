"""Exact-f32 tent contractions over extracted boxes (the structured
path's ``use_pallas_contract`` configuration):

    contract_R:  y[c, n] = sum_b Rst[c, b, n] * boxes[b, n]   (bs, NB)
    contract_P:  C[b, n] = sum_c Rst[c, b, n] * xc[c, n]      (box, NB)

The wrappers launch the kernels of csrc/contract.cu (replacing
saamge_tpu/ops/pallas_contract.py `_build_contract`) for CUDA tensors
and run the plain versions for CPU tensors.  Rst is f32 or bf16 (widened
to f32); boxes, xc and the outputs are f32.  The JAX ``pad_rst`` copy
((8, 128) tile padding) is a TPU artefact and is not ported.

On the card both kernels read only the tent's nonzeros, each through a
table built once at compile, and raise without it; the plain versions
ignore it.  contract_R reads ``lists`` (``slot_lists``: per output its
box nodes and values, outputs ranked by list length), launched by
``contract_R_plan`` (a warp per task of one length class);
contract_P reads, for each (box node, brick), only the slots of its
range in ``ranges`` (ops/window.slot_ranges).

Around them, in plain torch as in the JAX package: ``extract_boxes``
(the (box, NB) closed-brick windows of a node-grid vector, strided
copies) before R, and ``fold_boxes`` (each node taken from its master
brick, the 8-piece fold of the JAX apply_P, as one gather through
``fold_index``) after P."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.utils.logging import TIMERS


def extract_boxes(r: torch.Tensor, bricks, brick_elems) -> torch.Tensor:
    """Flat node-grid vector -> (box, NB) windows
    boxes[(u*(by+1)+v)*(bz+1)+w, p] = r[node (px*bx+u, py*by+v, pz*bz+w)]."""
    (BX, BY, BZ), (bx, by, bz) = bricks, brick_elems
    r3 = r.view(BX * bx + 1, BY * by + 1, BZ * bz + 1)
    win = r3.unfold(0, bx + 1, bx).unfold(1, by + 1, by) \
        .unfold(2, bz + 1, bz)            # (BX, BY, BZ, bx+1, by+1, bz+1)
    return win.permute(3, 4, 5, 0, 1, 2).reshape(
        (bx + 1) * (by + 1) * (bz + 1), BX * BY * BZ)


def fold_index(bricks, brick_elems, device="cpu") -> torch.Tensor:
    """int32 index into the flattened (box, NB) array of each node of the
    grid: node g along an axis is taken from brick (g - 1) // b at local
    g - b ((g - 1) // b) for g > 0, and from brick 0 at local 0 for g = 0
    (a shared plane belongs to the lower brick, the master rule of the
    MIS numbering)."""
    (BX, BY, BZ), (bx, by, bz) = bricks, brick_elems
    ax = []
    for B, b in ((BX, bx), (BY, by), (BZ, bz)):
        g = np.arange(B * b + 1)
        p = np.maximum(g - 1, 0) // b
        ax.append((p, g - p * b))
    (px, ux), (py, uy), (pz, uz) = ax
    NB = BX * BY * BZ
    local = ((ux[:, None, None] * (by + 1) + uy[None, :, None]) * (bz + 1)
             + uz[None, None, :])
    brick = (px[:, None, None] * BY + py[None, :, None]) * BZ \
        + pz[None, None, :]
    idx = local * NB + brick
    if idx.max() >= 2 ** 31:
        raise ValueError("the fold index exceeds 32 bits")
    return torch.as_tensor(idx.reshape(-1).astype(np.int32), device=device)


def fold_boxes(C: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(box, NB) -> flat node-grid vector, each node from its master
    brick through ``index = fold_index(bricks, brick_elems)``: the same
    values as the JAX apply_P's 8 static-slice pieces, as one gather."""
    return torch.index_select(C.reshape(-1), 0, index)


def contract_R_plain(Rst, boxes) -> torch.Tensor:
    return (Rst.to(torch.float32) * boxes.to(torch.float32)[None]).sum(1)


def contract_P_plain(Rst, xc) -> torch.Tensor:
    return (Rst.to(torch.float32) * xc.to(torch.float32)[:, None]).sum(0)


class SlotLists(NamedTuple):
    """contract R's table: for output o = (c, n) (at o = c NB + n) the
    ascending box nodes b of the nonzeros Rst[c, b, n] and their values
    widened to f32.  ``order`` (bs NB,) int32 lists the outputs by list
    length, longest first; rank k's list is [start[k], start[k + 1]) of
    ``val`` (f32) and ``node`` (int16).  Ranks [0, nlong) have more than
    8 terms, [nlong, nshort) 2 to 8, the rest 0 or 1."""
    order: torch.Tensor
    start: torch.Tensor
    val: torch.Tensor
    node: torch.Tensor
    nlong: int
    nshort: int


def slot_lists(Rst) -> SlotLists:
    """The by-slot node lists of a (bs, box, NB) Rst, on its device."""
    bs, box, NB = Rst.shape
    if box > 2 ** 15 or box * NB >= 2 ** 31:
        raise ValueError(f"{box} box nodes x {NB} bricks: the int16 node "
                         "ids hold at most 32768, the box offsets 2^31")
    R = Rst.detach().cpu().to(torch.float32).permute(0, 2, 1)  # (c, n, b)
    nz = torch.nonzero(R)                   # (c, n, b) lexicographic
    L = torch.bincount(nz[:, 0] * NB + nz[:, 1], minlength=bs * NB)
    order = torch.argsort(-L, stable=True)
    Ls = L[order]
    start = torch.zeros(bs * NB + 1, dtype=torch.int64)
    start[1:] = torch.cumsum(Ls, 0)
    first = torch.cumsum(L, 0) - L          # each output's first entry
    src = torch.repeat_interleave(first[order] - start[:-1], Ls) \
        + torch.arange(int(start[-1]))
    if int(start[-1]) >= 2 ** 31:
        raise ValueError("the slot lists exceed 32-bit offsets")
    nz = nz[src]
    order, start, val, node = (
        t.to(Rst.device) for t in (order.to(torch.int32),
                                   start.to(torch.int32),
                                   R[nz[:, 0], nz[:, 1], nz[:, 2]],
                                   nz[:, 2].to(torch.int16)))
    return SlotLists(order, start, val, node, nlong=int((L > 8).sum()),
                     nshort=int((L > 1).sum()))


R_THREADS = 256     # SAAMGE_THREADS of csrc/common.cuh: an R block


class ContractRPlan(NamedTuple):
    """Launch of csrc/contract.cu's R: a warp a task, ``tasks`` of them:
    ranks [0, nlong) one a warp (g = 32 lanes each), [nlong, nshort) four
    a warp (g = 8), the rest 32 a warp (g = 1)."""
    threads: int
    blocks: int
    nlong: int
    nshort: int
    outputs: int

    def ints(self):
        return tuple(self)

    @property
    def tasks(self) -> int:
        return (self.nlong + -(-(self.nshort - self.nlong) // 4)
                + -(-(self.outputs - self.nshort) // 32))

    def task(self, t: int):
        """(first rank, end rank, lanes per output) of task t, as the
        kernel computes them."""
        t8 = self.nlong + -(-(self.nshort - self.nlong) // 4)
        if t < self.nlong:
            return t, t + 1, 32
        if t < t8:
            k0 = self.nlong + 4 * (t - self.nlong)
            return k0, min(k0 + 4, self.nshort), 8
        k0 = self.nshort + 32 * (t - t8)
        return k0, min(k0 + 32, self.outputs), 1


def contract_R_plan(outputs: int, nlong: int, nshort: int) -> ContractRPlan:
    """The plan of ``outputs`` slot lists with length classes ``nlong``
    and ``nshort`` (SlotLists): 256-thread blocks, a warp a task."""
    if not 0 <= nlong <= nshort <= outputs or outputs * 32 >= 2 ** 31:
        raise ValueError(f"contract R: classes {nlong} <= {nshort} <= "
                         f"{outputs} outputs")
    plan = ContractRPlan(R_THREADS, 0, nlong, nshort, outputs)
    plan = plan._replace(blocks=-(-plan.tasks * 32 // R_THREADS))
    _build.check_plan(plan.threads, (plan.blocks,), 0)
    return plan


@functools.lru_cache(maxsize=32)
def _R_plan(outputs: int, nlong: int, nshort: int):
    return _build.int_array(contract_R_plan(outputs, nlong, nshort).ints())


def _check_ranges(ranges, Rst, x, what):
    if ranges is None:
        raise ValueError(f"{what} on the card needs the slot ranges of Rst "
                         "(ops/window.slot_ranges)")
    check(ranges, "ranges", torch.uint8, (2,) + tuple(Rst.shape[1:]))
    if ranges.device != x.device:
        raise ValueError(f"ranges on {ranges.device}, {what} input on "
                         f"{x.device}")


def contract_R(Rst, boxes, lists: SlotLists | None = None) -> torch.Tensor:
    """Rst (bs, box, NB), boxes (box, NB) -> (bs, NB).  On the card
    ``lists`` (slot_lists(Rst)) is required: the kernel reads them and
    not Rst."""
    if not is_cuda(Rst, boxes):
        return contract_R_plain(Rst, boxes)
    bs, box, NB = Rst.shape
    check(Rst, "Rst", (torch.float32, torch.bfloat16), (bs, box, NB))
    check(boxes, "boxes", torch.float32, (box, NB))
    if lists is None:
        raise ValueError("contract_R on the card needs the slot lists of "
                         "Rst (slot_lists)")
    nnz = lists.val.shape[0]
    for t, name, dtype, n in ((lists.order, "order", torch.int32, bs * NB),
                              (lists.start, "start", torch.int32,
                               bs * NB + 1),
                              (lists.val, "val", torch.float32, nnz),
                              (lists.node, "node", torch.int16, nnz)):
        check(t, name, dtype, (n,))
        if t.device != boxes.device:
            raise ValueError(f"slot lists on {t.device}, boxes on "
                             f"{boxes.device}")
    plan = _R_plan(bs * NB, lists.nlong, lists.nshort)
    lib = _build.load()
    y = torch.empty((bs, NB), dtype=torch.float32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        code = lib.saamge_contract_R(
            lists.order.data_ptr(), lists.start.data_ptr(),
            lists.val.data_ptr(), lists.node.data_ptr(), NB,
            ctypes.addressof(plan), boxes.data_ptr(), y.data_ptr(),
            _build.stream_ptr(boxes.device))
    _build.check_launch(lib, code, "contract_R")
    TIMERS.count("contract.kernel.R")
    return y


def contract_P(Rst, xc, ranges=None) -> torch.Tensor:
    """Rst (bs, box, NB), xc (bs, NB) -> (box, NB).  On the card
    ``ranges`` (slot_ranges(Rst)) is required."""
    if not is_cuda(Rst, xc):
        return contract_P_plain(Rst, xc)
    bs, box, NB = Rst.shape
    check(Rst, "Rst", (torch.float32, torch.bfloat16), (bs, box, NB))
    check(xc, "xc", torch.float32, (bs, NB))
    _check_ranges(ranges, Rst, xc, "contract_P")
    lib = _build.load()
    C = torch.empty((box, NB), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        code = lib.saamge_contract_P(
            int(Rst.dtype == torch.bfloat16), Rst.data_ptr(),
            ranges.data_ptr(), bs, box, NB, xc.data_ptr(), C.data_ptr(),
            _build.stream_ptr(xc.device))
    _build.check_launch(lib, code, "contract_P")
    TIMERS.count("contract.kernel.P")
    return C
