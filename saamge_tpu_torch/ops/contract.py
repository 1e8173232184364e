"""Exact-f32 tent contractions over extracted boxes (the structured
path's ``use_pallas_contract`` configuration):

    contract_R:  y[c, n] = sum_b Rst[c, b, n] * boxes[b, n]   (bs, NB)
    contract_P:  C[b, n] = sum_c Rst[c, b, n] * xc[c, n]      (box, NB)

The wrappers launch the kernels of csrc/contract.cu (replacing
saamge_tpu/ops/pallas_contract.py `_build_contract`) for CUDA tensors
and run the plain versions for CPU tensors.  Rst is f32 or bf16 (widened
to f32); boxes, xc and the outputs are f32.  The JAX ``pad_rst`` copy
((8, 128) tile padding) is a TPU artefact and is not ported.

Around them, in plain torch as in the JAX package: ``extract_boxes``
(the (box, NB) closed-brick windows of a node-grid vector, strided
copies) before R, and ``fold_boxes`` (each node taken from its master
brick, the 8-piece fold of the JAX apply_P) after P."""

from __future__ import annotations

import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build


def extract_boxes(r: torch.Tensor, bricks, brick_elems) -> torch.Tensor:
    """Flat node-grid vector -> (box, NB) windows
    boxes[(u*(by+1)+v)*(bz+1)+w, p] = r[node (px*bx+u, py*by+v, pz*bz+w)]."""
    (BX, BY, BZ), (bx, by, bz) = bricks, brick_elems
    r3 = r.view(BX * bx + 1, BY * by + 1, BZ * bz + 1)
    win = r3.unfold(0, bx + 1, bx).unfold(1, by + 1, by) \
        .unfold(2, bz + 1, bz)            # (BX, BY, BZ, bx+1, by+1, bz+1)
    return win.permute(3, 4, 5, 0, 1, 2).reshape(
        (bx + 1) * (by + 1) * (bz + 1), BX * BY * BZ)


def fold_boxes(C: torch.Tensor, bricks, brick_elems) -> torch.Tensor:
    """(box, NB) -> flat node-grid vector: node g along an axis is taken
    from brick (g - 1) // b at local g - b ((g - 1) // b) for g > 0, and
    from brick 0 at local 0 for g = 0 (a shared plane belongs to the
    lower brick, the master rule of the MIS numbering).  The same values
    as the JAX apply_P's 8 static-slice pieces, as one gather."""
    (BX, BY, BZ), (bx, by, bz) = bricks, brick_elems
    C6 = C.view(bx + 1, by + 1, bz + 1, BX, BY, BZ)
    idx = []
    for B, b in ((BX, bx), (BY, by), (BZ, bz)):
        g = torch.arange(B * b + 1, device=C.device)
        p = torch.clamp(g - 1, min=0) // b
        idx.append((p, g - p * b))
    (px, ux), (py, uy), (pz, uz) = idx
    y = C6[ux[:, None, None], uy[None, :, None], uz[None, None, :],
           px[:, None, None], py[None, :, None], pz[None, None, :]]
    return y.reshape(-1)


def contract_R_plain(Rst, boxes) -> torch.Tensor:
    return (Rst.to(torch.float32) * boxes.to(torch.float32)[None]).sum(1)


def contract_P_plain(Rst, xc) -> torch.Tensor:
    return (Rst.to(torch.float32) * xc.to(torch.float32)[:, None]).sum(0)


def _launch(mode: int, Rst, x, out_shape, what: str) -> torch.Tensor:
    bs, box, NB = Rst.shape
    check(Rst, "Rst", (torch.float32, torch.bfloat16), (bs, box, NB))
    lib = _build.load()
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.saamge_contract(
            mode, int(Rst.dtype == torch.bfloat16), Rst.data_ptr(), bs, box,
            NB, x.data_ptr(), out.data_ptr(), _build.stream_ptr(x.device))
    _build.check_launch(lib, code, what)
    return out


def contract_R(Rst, boxes) -> torch.Tensor:
    """Rst (bs, box, NB), boxes (box, NB) -> (bs, NB)."""
    if not is_cuda(Rst, boxes):
        return contract_R_plain(Rst, boxes)
    bs, box, NB = Rst.shape
    check(boxes, "boxes", torch.float32, (box, NB))
    y = _launch(0, Rst, boxes, (bs, NB), "contract_R")
    contract_R.launches += 1
    return y


def contract_P(Rst, xc) -> torch.Tensor:
    """Rst (bs, box, NB), xc (bs, NB) -> (box, NB)."""
    if not is_cuda(Rst, xc):
        return contract_P_plain(Rst, xc)
    bs, box, NB = Rst.shape
    check(xc, "xc", torch.float32, (bs, NB))
    C = _launch(1, Rst, xc, (box, NB), "contract_P")
    contract_P.launches += 1
    return C


contract_R.launches = 0
contract_P.launches = 0
