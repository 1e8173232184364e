"""Carry a JAX hierarchy's arrays over to the port.

``from_jax_compiled`` takes a saamge_tpu ``CompiledHierarchy`` (the
general path) and reads its arrays through ``np.asarray``; formats are
told apart by class name, so this module needs no JAX.  It covers DIA
(stored or the blocked ``PallasDIA`` layout), ELL, banded and block-row
levels, block-row and ELL transfer operators, and the coarsest inverse
formed from the Cholesky factor.

``from_jax_arrays`` takes the fields of a saamge_tpu
``StructuredHierarchy`` on the flat fine layout as numpy arrays, so
that this module needs no JAX:

  d["A0.vals2"], d["A0s.vals2"]  (k, n_rows_pad, 128) tiled diagonals (no
                                 "A0s.vals2": the smoother is A0 itself)
  d["dinv0h"]                    (t_rows, 128) haloed fine scaling
  d["taus0"]                     1/tau of each fine root
  d["Rst"]                       (bs, box, NB) tent blocks
  d["flat_id"], d["Ainv"]        real-dof ids, the coarsest inverse

and, for three levels (a two-level hierarchy has none of these),

  d["taus1"], d["dinv1"]         the mid roots and scaling
  d["A1d.blocks"]                (k1, bs, bs, NB) mid blocks (and from
                                 them the resident chain's tiles, as
                                 compile_structured builds them), or
  d["A1d"]                       the dense (n1, n1) mid operator
  d["Rst1"], d["flat_id2"]       superbrick tent blocks and their ids, or
  d["R1"]                        the dense coarsest restriction

and ``meta`` with "offsets", "n", "hr" (the TPU layout's halo rows),
"bricks", "brick_elems", and where they apply "doffs", "rects" and
"supers" (None or absent without superbricks).  A capacity
hierarchy (mfree, hbm_frugal) has in place of the stored operators

  d["A0s.c_h"], d["A0s.m_h"]     (t_rows, 128) matrix-free smoother twin
  d["A0m.c_h"], d["A0m.m_h"]     the matrix-free PCG operator (in place
                                 of "A0.vals2")
  d["K"]                         (8, 8) reference element matrix
  d["A1kC"]                      per offset (r2, r1p, Lpad) packed blocks
                                 (in place of "A1d.blocks"; carried over
                                 as the port's compact packing)
  d["Wc.rstw"]                   (NBxy, bs, box_xy, Lzp) window-kernel
                                 layout of the tent blocks (in place of
                                 "Rst", which is a placeholder there)

and a hierarchy built with ``use_pallas_contract`` has d["Rst_pad"], the
(bs, boxp, NBp) tile-padded tent blocks; the padding is stripped and the
port's hierarchy runs the contraction kernels.

Storage dtypes are kept (a bf16 array stays bf16)."""

from __future__ import annotations

import numpy as np
import torch

from saamge_tpu_torch.ops.blockrow import BlockRow, TransposedBlockRow
from saamge_tpu_torch.ops.mfree import MatrixFreeQ1, q1_halo
from saamge_tpu_torch.ops.midmv import pack_mid
from saamge_tpu_torch.ops.sparse import DIA, ELL, Banded
from saamge_tpu_torch.solve.compiled import (CompiledHierarchy,
                                             CompiledLevel, coarse_inverse)
from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                               StructuredHierarchy,
                                               mid_buffers)

LANES = 128            # lane width of the TPU (rows, 128) layout


def _tensor(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, keeping bf16/f32/int."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a, copy=True))


def _rst_from_window(rstw, bricks, brick_elems) -> torch.Tensor:
    """Inverse of saamge_tpu/ops/pallas_window.py relayout_rst: the
    (NBxy, bs, box_xy, Lzp) window layout -> (bs, box, NB)."""
    (bx, by, bz), (BX, BY, BZ) = brick_elems, bricks
    rstw = np.asarray(rstw)
    bs = rstw.shape[1]
    Rv = rstw[..., :BZ * (bz + 1)].reshape(BX * BY, bs, bx + 1, by + 1, BZ,
                                           bz + 1)
    Rst = Rv.transpose(1, 2, 3, 5, 0, 4).reshape(
        bs, (bx + 1) * (by + 1) * (bz + 1), BX * BY * BZ)
    return _tensor(np.ascontiguousarray(Rst))


def from_jax_arrays(d: dict, meta: dict,
                    device="cpu") -> StructuredHierarchy:
    n = int(meta["n"])
    k = len(meta["offsets"])
    geo = BrickGeometry(tuple(meta["bricks"]), tuple(meta["brick_elems"]))
    lo = int(meta["hr"]) * LANES

    def unhalo(v):
        """(t_rows, 128) haloed TPU layout -> the flat (n,) entries."""
        return _tensor(np.asarray(v).reshape(-1)[lo:lo + n])

    def fine_op(dia_key, mf_key):
        if dia_key in d:
            vals = _tensor(np.asarray(d[dia_key]).reshape(k, -1)[:, :n])
            return DIA(vals, tuple(meta["offsets"]), n)
        K = tuple(tuple(float(v) for v in row) for row in np.asarray(d["K"]))
        h = q1_halo(geo.nodes)
        c, m = (torch.nn.functional.pad(unhalo(d[f"{mf_key}.{f}"]), (h, h))
                for f in ("c_h", "m_h"))
        return MatrixFreeQ1(c, m, K, geo.nodes)

    if "A1d.blocks" in d:
        mid = mid_buffers(_tensor(d["A1d.blocks"]), meta["doffs"],
                          meta["rects"], geo.bricks, device)
    elif "A1kC" in d:
        # the nonzeros of the JAX packed rectangles (r2, r1p, Lpad), per
        # offset, in the compact packing (ops/midmv.pack_mid)
        NB = geo.num_bricks
        coo = []
        for k, (a, (r1, r2)) in enumerate(zip(d["A1kC"], meta["rects"])):
            rect = _tensor(np.ascontiguousarray(
                np.asarray(a)[:r2, :r1, :NB].transpose(1, 0, 2)))
            s1, s2, p = rect.nonzero(as_tuple=True)
            coo.append((torch.full_like(p, k), p, s1, s2, rect[s1, s2, p]))
        k, p, s1, s2, vals = (torch.cat(c) for c in zip(*coo))
        vals, index = pack_mid(k.numpy(), p.numpy(), s1.numpy(), s2.numpy(),
                               vals, meta["doffs"], geo.bricks,
                               np.asarray(d["dinv1"]).size // NB)
        mid = {"A1_packed": vals, "A1_index": index}
    elif "A1d" in d:
        mid = {"A1_dense": _tensor(d["A1d"])}
    else:
        mid = {}
    if "dinv1" in d:
        mid.update(dinv1=_tensor(d["dinv1"]),
                   taus1=np.asarray(d["taus1"], np.float32).reshape(-1),
                   doffs=meta.get("doffs", ()), rects=meta.get("rects", ()))
    for key in ("Rst1", "flat_id2", "R1"):
        if key in d:
            mid[key] = _tensor(d[key])
    if "Rst_pad" in d:
        Rst = _tensor(np.ascontiguousarray(
            np.asarray(d["Rst_pad"])[:, :geo.box, :geo.num_bricks]))
    elif "Wc.rstw" in d:
        Rst = _rst_from_window(d["Wc.rstw"], geo.bricks, geo.brick_elems)
    else:
        Rst = _tensor(d["Rst"])
    A0 = fine_op("A0.vals2", "A0m")
    A0s = (fine_op("A0s.vals2", "A0s")
           if "A0s.vals2" in d or "A0s.c_h" in d else A0)
    h = StructuredHierarchy(
        A0=A0, A0s=A0s, dinv0=unhalo(d["dinv0h"]),
        taus0=np.asarray(d["taus0"], np.float32).reshape(-1), Rst=Rst,
        flat_id=_tensor(d["flat_id"]), Ainv=_tensor(d["Ainv"]), geo=geo,
        supers=meta.get("supers"), contract="Rst_pad" in d, **mid)
    return h.to(device)


def _format(M):
    """A JAX device matrix (by class name) -> the port's format."""
    kind = type(M).__name__
    n, m = (int(s) for s in M.shape)
    if kind == "DeviceDIA":
        return DIA(_tensor(M.vals), tuple(M.offsets), n)
    if kind == "PallasDIA":
        k = len(M.offsets)
        return DIA(_tensor(np.asarray(M.vals2).reshape(k, -1)[:, :n]),
                   tuple(M.offsets), n)
    if kind == "DeviceELL":
        return ELL(_tensor(M.cols).to(torch.int64), _tensor(M.vals), (n, m))
    if kind == "DeviceBanded":
        return Banded(_tensor(M.blocks), M.lo, (n, m))
    if kind == "DeviceBlockRow":
        return BlockRow([(_tensor(b.blocks), _tensor(b.colidx).to(torch.int64),
                          _tensor(b.row0).to(torch.int64))
                         for b in M.buckets],
                        _tensor(M.gather_rows).to(torch.int64), (n, m))
    raise TypeError(f"no port format for a JAX {kind}")


def from_jax_compiled(hj, device="cpu") -> CompiledHierarchy:
    """The port's CompiledHierarchy from a saamge_tpu CompiledHierarchy
    (same formats, values and roots; the coarsest inverse formed from
    its Cholesky factor as ``compile_hierarchy`` forms it)."""
    levels = []
    for lv in hj.levels:
        R = _format(lv.R)
        P = (TransposedBlockRow(R) if type(lv.P).__name__
             == "TransposedBlockRow" else _format(lv.P))
        levels.append(CompiledLevel(
            _format(lv.A), P, R, _tensor(lv.dinv), np.asarray(lv.roots),
            np.asarray(lv.roots2), float(np.asarray(lv.weightfirst))))
    L = _tensor(hj.chol)
    return CompiledHierarchy(levels, coarse_inverse(L, L.dtype, "cpu"),
                             L.shape[0]).to(device)
