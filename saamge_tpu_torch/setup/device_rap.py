"""Galerkin triple product Ac = P^T A P on the device for the structured
(brick / tent) setup: brick-window contractions in place of the host
scipy SpGEMM chain.

Port of saamge_tpu/setup/device_rap.py.  The reference computes the
coarse operator with hypre's distributed RAP (tg.hpp:696,
interp.cpp:177-228).  With a Cartesian brick partitioning and a tent P,
every column of P lives in its master brick's closed dof box and the
fine A is a <=27-point stencil, so

  1. AP is brick-local with an EXTENDED window: for t in the
     (b+3)^3 box around brick q (global node u = q*b + t - 1),
       APq[s', t, q] = sum_e a_e[u] * Rst[s', t-1+e, q]
     where a_e[u] = A[u, u+e] are the DIA diagonals of A: 27
     elementwise multiply-adds over statically sliced windows;
  2. Ac couples only neighbour bricks (|d|_inf <= 1):
       Ac_d[s, s', p] = sum_w Rst[s, w, p] * APq[s', w - d*b + 1, p+d]
     27 contractions over the static window overlaps, batched over the
     bricks (``torch.einsum``, a batched matmul; the JAX package computes
     them outside any Pallas kernel too).

The arithmetic is float32 with TF32 off (``_device.pin_fp32_precision``,
the JAX ``precision="highest"``); the (27, bs, bs, NB) blocks are fetched
and scattered into a scipy CSR for the rest of the (host, f64) setup, so
Ac differs from the f64 host product at the f32 representation level
(~1e-6 relative).  It is therefore opt-in (``rap_override``).

``sharded_structured_rap`` computes the same product over an x-slab
shard mesh (parallel/mesh.ShardMesh).  Not ported: ``_rap_scan_jit``
(the ``lax.scan`` form that exists only to shrink an XLA compile)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from saamge_tpu_torch._device import card_or_cpu
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.utils.logging import TIMERS, sa_print

NEIGHBOURS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1))


def _expand_ext(x: torch.Tensor, axis: int, b: int,
                nb: int) -> torch.Tensor:
    """(..., nb*b+pad, ...) -> (..., nb, b+3, ...): the window
    [p*b-1, p*b+b+1] of each brick p along one axis (the grid must be
    pre-padded by 1 zero in front and >= b+2 zeros behind along it).
    Plane k of brick p sits at padded index p*b + k, k = 0..b+2: one
    strided view per brick (``unfold``), no copy."""
    w = x.unfold(axis, b + 3, b).narrow(axis, 0, nb)
    return w.movedim(-1, axis + 1)               # (..., nb, b+3, ...)


def _neighbor_shift(blk: torch.Tensor, d, bricks) -> torch.Tensor:
    """blk (..., BX, BY, BZ) -> the values of brick p+d at index p (zero
    beyond the grid)."""
    out = blk
    for ax, (dd, Bn) in enumerate(zip(d, bricks)):
        if dd == 0:
            continue
        axis = out.dim() - 3 + ax
        shifted = torch.zeros_like(out)
        if dd == 1:
            shifted.narrow(axis, 0, Bn - 1).copy_(out.narrow(axis, 1, Bn - 1))
        else:
            shifted.narrow(axis, 1, Bn - 1).copy_(out.narrow(axis, 0, Bn - 1))
        out = shifted
    return out


def _ranges(dd: int, b: int) -> Tuple[int, int, int]:
    """Per-axis overlap of w in [0,b] with t' = w - dd*b + 1 in
    [0, b+2]: returns (w_lo, w_hi_inclusive, t_lo)."""
    if dd == 0:
        return 0, b, 1
    if dd == 1:
        return b - 1, b, 0
    return 0, 1, b + 1


def _compute_ap(vals3x: torch.Tensor, rst6: torch.Tensor, be, offsets3,
                x_prehaloed: bool = False) -> torch.Tensor:
    """APq (bs, bx+3, by+3, bz+3, BXl, BY, BZ) from DIA diagonal node
    grids.  With ``x_prehaloed`` the x axis of vals3x already carries
    the one-node halo planes (sharded slabs); y/z are padded here."""
    bx, by, bz = be
    bs = rst6.shape[0]
    BXl, BY, BZ = rst6.shape[-3:]
    ap = torch.zeros((bs, bx + 3, by + 3, bz + 3, BXl, BY, BZ),
                     dtype=torch.float32, device=rst6.device)

    def tr(e, b):
        # inclusive t range with w = t - 1 + e in [0, b]; for
        # e in {-1,0,1} the w range is always the full window
        return max(0, 1 - e), min(b + 2, b + 1 - e)

    xpad = (0, 2) if x_prehaloed else (1, bx + 2)
    for j, (ex, ey, ez) in enumerate(offsets3):
        # F.pad takes the last axis first
        g = torch.nn.functional.pad(vals3x[j], (1, bz + 2, 1, by + 2) + xpad)
        X = _expand_ext(g, 0, bx, BXl)
        X = _expand_ext(X, 2, by, BY)
        X = _expand_ext(X, 4, bz, BZ)
        exw = X.permute(1, 3, 5, 0, 2, 4)
        ax0, ax1 = tr(ex, bx)
        ay0, ay1 = tr(ey, by)
        az0, az1 = tr(ez, bz)
        t_sl = (slice(ax0, ax1 + 1), slice(ay0, ay1 + 1),
                slice(az0, az1 + 1))
        ap[(slice(None),) + t_sl].add_(exw[t_sl] * rst6)
    return ap


def _rap_blocks(ap_ext: torch.Tensor, rst6: torch.Tensor,
                be) -> torch.Tensor:
    """The 27 neighbour-offset coarse blocks (27, bs, bs, NB_loc) from
    the x-EXTENDED AP (bs, bx+3, by+3, bz+3, BXl+2, BY, BZ): the
    x-neighbour columns come from the two extra brick layers (zero or
    halo-exchanged), y/z from in-grid shifts."""
    bx, by, bz = be
    bs = rst6.shape[0]
    BXl, BY, BZ = rst6.shape[-3:]
    nb = BXl * BY * BZ
    blocks = []
    for dx, dy, dz in NEIGHBOURS:
        wx0, wx1, tx0 = _ranges(dx, bx)
        wy0, wy1, ty0 = _ranges(dy, by)
        wz0, wz1, tz0 = _ranges(dz, bz)
        r_sl = (slice(None), slice(wx0, wx1 + 1), slice(wy0, wy1 + 1),
                slice(wz0, wz1 + 1))
        t_sl = (slice(None), slice(tx0, tx0 + wx1 - wx0 + 1),
                slice(ty0, ty0 + wy1 - wy0 + 1),
                slice(tz0, tz0 + wz1 - wz0 + 1))
        apn = ap_ext[t_sl][..., 1 + dx:1 + dx + BXl, :, :]
        apn = _neighbor_shift(apn, (0, dy, dz), (BXl, BY, BZ))
        blocks.append(torch.einsum("swn,zwn->szn",
                                   rst6[r_sl].reshape(bs, -1, nb),
                                   apn.reshape(bs, -1, nb)))
    return torch.stack(blocks)              # (27, bs, bs, NB_loc)


def rap_blocks(vals3: torch.Tensor, rst6: torch.Tensor, be,
               offsets3) -> torch.Tensor:
    """The statically unrolled product (the JAX ``_rap_jit``): vals3
    (k, NXn, NYn, NZn) DIA diagonals as node grids, rst6 (bs, bx+1,
    by+1, bz+1, BX, BY, BZ) the tent blocks; returns the (27, bs, bs, NB)
    neighbour-offset blocks."""
    ap = _compute_ap(vals3, rst6, be, offsets3)
    ap_ext = torch.nn.functional.pad(ap, (0, 0, 0, 0, 1, 1))
    del ap
    return _rap_blocks(ap_ext, rst6, be)


def _offsets3(offsets, nodes):
    """DIA offsets -> (dx, dy, dz) stencil triples, or None when an
    offset is no neighbour (|d|_inf > 1) of the node grid."""
    NYn, NZn = nodes[1], nodes[2]
    out = []
    for o in offsets:
        o = int(o)
        ex, r = divmod(o + NYn * NZn + NZn + 1, NYn * NZn)
        ey, ez = divmod(r, NZn)
        tri = (ex - 1, ey - 1, ez - 1)
        if (tri[0] * NYn * NZn + tri[1] * NZn + tri[2] != o
                or max(abs(t) for t in tri) > 1):
            return None
        out.append(tri)
    return out


def stencil_diagonals(A: sp.spmatrix, geo):
    """(DIA in f32 on the host, offsets3) when A is a <=27-point stencil
    on the node grid of ``geo``, else (None, the reason).  Host work
    only: it decides the route before any device work."""
    nodes = geo.nodes
    if A.shape != (int(np.prod(nodes)),) * 2:
        return None, (f"A is {A.shape}, the node grid {nodes} has "
                      f"{int(np.prod(nodes))} nodes")
    dia = DIA.try_from_csr(A, torch.float32, max_diags=64)
    if dia is None:
        return None, "A has more than 64 diagonals"
    offsets3 = _offsets3(dia.offsets, nodes)
    if offsets3 is None:
        return None, "A couples nodes beyond the 27-point neighbourhood"
    return dia, offsets3


def brick_tent(rels, tent_interp: sp.csr_matrix, mis_numcoarsedof, geo):
    """``build_structured_interp``'s (Rst_bm, cd_brick, slot, bs) of a
    tent on ``geo``'s bricks.  Raises ValueError when the partition is
    not geo's Cartesian bricks (another count of parts, or a tent column
    outside its master brick's closed box), as the JAX package does.
    Host work only, done before any device work."""
    from saamge_tpu_torch.solve.structured import build_structured_interp
    if rels.nparts != geo.num_bricks:
        raise ValueError(f"the partition has {rels.nparts} parts, geo "
                         f"{geo.num_bricks} bricks: partitioning is not "
                         "brick-structured")
    return build_structured_interp(rels, tent_interp, mis_numcoarsedof, geo)


def structured_rap(A: sp.csr_matrix, rels, tent_interp: sp.csr_matrix,
                   mis_numcoarsedof, geo, device="cuda",
                   stats: Optional[dict] = None) -> sp.csr_matrix:
    """Ac = P^T A P on ``device`` (a card unless ``"cpu"`` is asked for)
    for a brick-structured tent P; ``geo``: the partitioning's
    ``solve.structured.BrickGeometry``.  Raises ValueError when A is not
    a stencil on geo's node grid or the partition is not geo's bricks.
    ``stats``, when given, receives the block size ``bs`` and the bytes
    of the blocks."""
    dev = card_or_cpu(device)
    with TIMERS.phase("setup.rap_device"):
        dia, offsets3 = stencil_diagonals(A, geo)
        if dia is None:
            raise ValueError(f"A is not stencil-structured: {offsets3}")
        tent = brick_tent(rels, tent_interp, mis_numcoarsedof, geo)
        return _structured_rap(dia, offsets3, tent, geo, dev, stats)


def _structured_rap(dia, offsets3, tent, geo, dev, stats):
    """The product of a checked stencil operator and brick tent (inside
    the caller's ``setup.rap_device`` phase, as in JAX)."""
    bx, by, bz = be = geo.brick_elems
    BX, BY, BZ = geo.bricks
    vals3 = dia.vals.reshape(len(offsets3), *geo.nodes).to(dev)
    Rst_bm, cd_brick, slot, bs = tent
    rst6 = torch.as_tensor(np.ascontiguousarray(
        Rst_bm.transpose(1, 2, 0))).reshape(
        bs, bx + 1, by + 1, bz + 1, BX, BY, BZ).to(dev)
    del Rst_bm, tent
    with TIMERS.phase("setup.rap_device.blocks"):
        blocks = rap_blocks(vals3, rst6, be, offsets3).cpu().numpy()
    del vals3, rst6
    if stats is not None:
        stats.update(bs=bs, blocks_bytes=blocks.nbytes)
    with TIMERS.phase("setup.rap_device.csr"):
        return _assemble_csr(blocks, cd_brick, slot, bs, geo)


def _assemble_csr(blocks: np.ndarray, cd_brick, slot, bs: int,
                  geo) -> sp.csr_matrix:
    """(27, bs, bs, NB) neighbour-offset blocks -> coarse CSR on the
    real (unpadded) coarse dof numbering."""
    BX, BY, BZ = geo.bricks
    NB = geo.num_bricks
    # coarse id of (p, s): invert (cd_brick, slot)
    cid = np.full((NB, bs), -1, np.int64)
    cid[cd_brick, slot] = np.arange(len(cd_brick))
    rows, cols, vals = [], [], []
    p3 = np.arange(NB)
    px, r = divmod(p3, BY * BZ)
    py, pz = divmod(r, BZ)
    s_i, s_j = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    for di, (dx, dy, dz) in enumerate(NEIGHBOURS):
        qx, qy, qz = px + dx, py + dy, pz + dz
        ok = ((qx >= 0) & (qx < BX) & (qy >= 0) & (qy < BY)
              & (qz >= 0) & (qz < BZ))
        p_ok = p3[ok]
        q_ok = (qx[ok] * BY + qy[ok]) * BZ + qz[ok]
        blk = blocks[di][:, :, p_ok]              # (bs, bs, m)
        ri = cid[p_ok][:, s_i.ravel()]            # (m, bs*bs)
        cj = cid[q_ok][:, s_j.ravel()]
        vv = blk.reshape(bs * bs, -1).T           # (m, bs*bs)
        keep = (ri >= 0) & (cj >= 0)
        rows.append(ri[keep])
        cols.append(cj[keep])
        vals.append(vv[keep])
    nc = len(cd_brick)
    Ac = sp.coo_matrix(
        (np.concatenate(vals).astype(np.float64),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(nc, nc)).tocsr()
    Ac.sum_duplicates()
    # drop explicit zeros from the padded blocks
    Ac.eliminate_zeros()
    sa_print(4, "device RAP: nc=%d nnz=%d bs=%d", nc, Ac.nnz, bs)
    return Ac


def make_structured_rap_override(geo, device="cuda"):
    """rap_override for ml_produce_data: the device RAP on ``device`` at
    the finest coarsening (where the brick / tent structure holds), the
    host scipy product elsewhere.  The route is decided on the host from
    the operator's structure before any device work (JAX takes the host
    product on any AssertionError instead); a partition that is not
    geo's bricks raises ValueError before any device work, as JAX's
    ``build_structured_interp`` raises it outside that route; a device
    error raises.  The returned function keeps the ``bs`` and block bytes
    of its last device product in its attribute ``stats`` (empty while
    every call took the host product)."""
    dev = card_or_cpu(device)

    def override(A, tg, rels, level):
        if level != 0 or tg.smooth_interp:
            return None                   # the host product
        with TIMERS.phase("setup.rap_device"):
            dia, offsets3 = stencil_diagonals(A, geo)
            if dia is None:
                sa_print(1, "device RAP: host product, %s", offsets3)
                return None
            tent = brick_tent(rels, tg.tent_interp,
                              tg.interp_data.mis_numcoarsedof, geo)
            return _structured_rap(dia, offsets3, tent, geo, dev,
                                   override.stats)

    override.stats = {}
    return override


def sharded_structured_rap(A: sp.csr_matrix, rels,
                           tent_interp: sp.csr_matrix, mis_numcoarsedof,
                           geo, mesh) -> sp.csr_matrix:
    """Ac = P^T A P over an x-slab ShardMesh (parallel/mesh.py), the
    hypre ParCSR RAP analog (interp.cpp:177-228): each shard computes the
    AP window blocks of its own bricks from its node slab, with the
    one-node overlap planes of the ext-window halo; exchanges one brick
    layer of AP with each x-neighbour (``ppermute``); and contracts its
    own 27 coarse blocks.  The blocks are fetched and assembled into the
    CSR on the host (``_assemble_csr``), as one controller does in JAX.
    Raises ValueError as ``structured_rap`` does, and when the shards do
    not divide the brick layers along x."""
    with TIMERS.phase("setup.rap_device"):
        dia, offsets3 = stencil_diagonals(A, geo)
        if dia is None:
            raise ValueError(f"A is not stencil-structured: {offsets3}")
        ndev = mesh.size
        BX, BY, BZ = geo.bricks
        if BX % ndev:
            raise ValueError(f"{ndev} shards do not divide the {BX} brick "
                             "layers along x")
        Rst_bm, cd_brick, slot, bs = brick_tent(
            rels, tent_interp, mis_numcoarsedof, geo)
        bx, by, bz = be = geo.brick_elems
        nodes = geo.nodes
        BXl = BX // ndev
        slab = BXl * bx
        k = len(offsets3)
        vals = dia.vals.reshape(k, *nodes)
        rst6 = torch.as_tensor(np.ascontiguousarray(
            Rst_bm.transpose(1, 2, 0))).reshape(
            bs, bx + 1, by + 1, bz + 1, BX, BY, BZ)
        del Rst_bm
        rsts, aps = [], []
        for d, dev in enumerate(mesh.devices):
            # node planes [d*slab - 1, (d+1)*slab + 1], zeros off the grid
            lo = d * slab - 1
            s0, s1 = max(0, lo), min(nodes[0], lo + slab + 3)
            v = torch.zeros((k, slab + 3) + tuple(nodes[1:]),
                            dtype=torch.float32)
            v[:, s0 - lo:s1 - lo] = vals[:, s0:s1]
            rsts.append(rst6[..., d * BXl:(d + 1) * BXl, :, :]
                        .contiguous().to(dev))
            aps.append(_compute_ap(v.to(dev), rsts[-1], be, offsets3,
                                   x_prehaloed=True))
        # one brick layer of AP from each x-neighbour (zeros at the ends)
        from_left = mesh.ppermute_right([ap[..., -1:, :, :] for ap in aps])
        from_right = mesh.ppermute_left([ap[..., :1, :, :] for ap in aps])
        with TIMERS.phase("setup.rap_device.blocks"):
            blocks = torch.cat([
                _rap_blocks(torch.cat([lft, ap, rgt], -3), rst, be).cpu()
                .reshape(27, bs, bs, BXl, BY, BZ)
                for ap, lft, rgt, rst in zip(aps, from_left, from_right,
                                             rsts)], 3)
        del aps, rsts, from_left, from_right
        with TIMERS.phase("setup.rap_device.csr"):
            return _assemble_csr(blocks.reshape(27, bs, bs, -1).numpy(),
                                 cd_brick, slot, bs, geo)
