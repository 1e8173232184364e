"""Carry a JAX StructuredHierarchy's arrays over to the port.

``from_jax_arrays`` takes the fields of a saamge_tpu
``StructuredHierarchy`` (built with super_bricks) as numpy arrays, so
that this module needs no JAX:

  d["A0.vals2"], d["A0s.vals2"]  (k, n_rows_pad, 128) tiled diagonals
  d["dinv0h"]                    (t_rows, 128) haloed fine scaling
  d["taus0"], d["taus1"]         1/tau of each root
  d["Rst"]                       (bs, box, NB) tent blocks
  d["A1d.blocks"]                (k1, bs, bs, NB) mid blocks
  d["dinv1"], d["Rst1"], d["flat_id"], d["flat_id2"], d["Ainv"]

and ``meta`` with "offsets", "n", "hr" (the TPU layout's halo rows),
"doffs", "rects", "bricks", "brick_elems" and "supers".  Storage dtypes
are kept (a bf16 array stays bf16)."""

from __future__ import annotations

import numpy as np
import torch

from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                               StructuredHierarchy)

LANES = 128            # lane width of the TPU (rows, 128) layout


def _tensor(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, keeping bf16/f32/int."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a, copy=True))


def from_jax_arrays(d: dict, meta: dict,
                    device="cpu") -> StructuredHierarchy:
    n = int(meta["n"])
    k = len(meta["offsets"])

    def diagonals(v):
        return _tensor(np.asarray(v).reshape(k, -1)[:, :n])

    lo = int(meta["hr"]) * LANES
    dinv0 = _tensor(np.asarray(d["dinv0h"]).reshape(-1)[lo:lo + n])
    h = StructuredHierarchy(
        A0_vals=diagonals(d["A0.vals2"]),
        A0s_vals=diagonals(d["A0s.vals2"]),
        offsets=meta["offsets"], dinv0=dinv0,
        taus0=np.asarray(d["taus0"], np.float32).reshape(-1),
        Rst=_tensor(d["Rst"]), A1_blocks=_tensor(d["A1d.blocks"]),
        doffs=meta["doffs"], rects=meta["rects"],
        dinv1=_tensor(d["dinv1"]),
        taus1=np.asarray(d["taus1"], np.float32).reshape(-1),
        Rst1=_tensor(d["Rst1"]), flat_id=_tensor(d["flat_id"]),
        flat_id2=_tensor(d["flat_id2"]), Ainv=_tensor(d["Ainv"]),
        geo=BrickGeometry(tuple(meta["bricks"]),
                          tuple(meta["brick_elems"])),
        supers=meta["supers"])
    return h.to(device)
