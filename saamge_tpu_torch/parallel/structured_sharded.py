"""The structured flagship solve sharded into x-slabs over a ShardMesh.

Port of saamge_tpu/parallel/structured_sharded.py on the port's flat
fine layout (ops/sparse.DIA: a haloed vector, ``halo = max|offset|``
rows of zeros on each side); the JAX z-lane layout is not ported.  A
Cartesian brick grid splits into slabs of ``BX / P`` brick layers, so
every operator needs one plane (fine level) or one brick layer (mid
level) of each x-neighbour:

  - Shard d holds its CLOSED slab, node planes d*slab .. (d+1)*slab
    (``slab = bx * BX / P``): one contiguous range of the flat node
    ordering.  The plane two shards share is held by both, and both
    compute it bit for bit.  A pass fills the halo's plane next to the
    slab with the neighbour's plane (``halo_fill``); the rest of the
    halo (NZn + 1 rows a side) stays zero, and only zero diagonals
    reach it.  Each fine pass is the single-card kernel on the slab:
    the stencil (csrc/stencil.cu: spmv, residual and root modes on
    slab diagonals) and window R / P on the slab's brick grid
    (csrc/window.cu).  After P a shard's first plane is its left
    neighbour's last (the tent entry of a shared node lives in the
    lower brick).
  - Mid vectors (slot-major, ``s * nb_loc + p``) are split by brick
    layers.  The default DISTRIBUTED mid keeps the brick blocks, dinv1
    and the coarsest restriction per shard: the mid matvec exchanges one
    brick layer a side and runs in plain torch (the JAX code is XLA),
    the superbrick coarsest contracts each shard's chunk of superbricks
    and solves the all-gathered n2-vector with the replicated inverse,
    and the dense ``R1`` branch adds the shards' partial products with
    ``psum``.  The REPLICATED mid (``mid_replicated=True``, and the only
    route for an ``hbm_frugal`` or dense-mid hierarchy) all-gathers the
    restricted residual and runs the hierarchy's own ``mid_correct`` on
    each device: the resident mid chain (csrc/midsmooth.cu) or the
    packed passes (csrc/midmv.cu), once per device.
  - PCG is solve/device_pcg.PCGRunner on sharded vectors
    (parallel/mesh.ShardTensor) with the dot that counts a shared plane
    once (``ShardedStructured.dot``); on a mesh whose shards share one
    card its prologue, iteration and the V-cycle are captured CUDA
    graphs, cached on the ShardedStructured.

The smoothing is the JAX sharded path's: per root one halo fill and one
stencil root pass on the bf16 twin, then a residual pass (not the
single-card wavefront sweep); a matrix-free twin is replaced by the
stored f32 operator, as in JAX."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.stencil import stencil_h
from saamge_tpu_torch.ops.window import window_P, window_R
from saamge_tpu_torch.parallel.mesh import ShardMesh, ShardTensor
from saamge_tpu_torch.solve.device_pcg import graphed, pcg
from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                               StructuredHierarchy)


@dataclasses.dataclass(frozen=True)
class StructShardStatic:
    """Static geometry of the sharded solve."""
    geo: BrickGeometry
    ndev: int
    plane: int          # rows of one x-plane of nodes (NYn * NZn)
    sp1: int            # closed-slab planes per shard (slab + 1)
    halo: int           # halo rows a side (max |offset|)
    offsets: tuple
    doffs: tuple        # brick offsets of the mid operator
    bs: int
    nb_loc: int         # bricks per shard (bxl * BY * BZ)
    taus0: tuple        # 1 / tau of the fine and the mid roots
    taus1: tuple
    # superbrick coarsest restriction, split by flat superbrick chunks:
    # the superbrick grid, the level-2 block size, chunk width per shard
    supers: Optional[tuple] = None
    bs2: int = 0
    nb2c: int = 0

    @property
    def real(self) -> int:
        return self.sp1 * self.plane

    @property
    def bxl(self) -> int:
        return self.geo.bricks[0] // self.ndev


class MidBundle(torch.nn.Module):
    """The mid level and coarsest of a three-level StructuredHierarchy,
    replicated on one device: the hierarchy's own mid methods on its mid
    buffers (no copy where the device is the hierarchy's)."""

    BUFFERS = ("A1_blocks", "A1_tiles", "A1_packed", "A1_dense", "dinv1",
               "Rst1", "R1", "flat_id", "flat_id2", "Ainv")
    mid_route = StructuredHierarchy.mid_route
    mid_correct = StructuredHierarchy.mid_correct
    _dense_correct = StructuredHierarchy._dense_correct
    mid_pass = StructuredHierarchy.mid_pass
    mid_matvec = StructuredHierarchy.mid_matvec
    coarsest_correct = StructuredHierarchy.coarsest_correct
    apply_R1 = StructuredHierarchy.apply_R1
    apply_P1 = StructuredHierarchy.apply_P1
    _super_dims = StructuredHierarchy._super_dims

    def __init__(self, h: StructuredHierarchy):
        super().__init__()
        for name in self.BUFFERS:
            self.register_buffer(name, getattr(h, name))
        self.bs, self.geo, self.supers = h.bs, h.geo, h.supers
        self.doffs, self.rects, self.taus1 = h.doffs, h.rects, h.taus1
        self.mid_plan = h.mid_plan


class _Shard(torch.nn.Module):
    """One shard's buffers: the slab's f32 diagonals ``A0_vals`` (k,
    real) and smoother twin ``A0s_vals`` (the f32 ones again where the
    hierarchy's twin is matrix-free),
    the haloed fine scaling ``dinv0h``, the tent blocks ``Rst`` (bs,
    box, nb_loc) with their slot ranges ``Rst_rng``; for the distributed
    mid the brick blocks ``blocks1`` (k1, bs, bs, nb_loc), ``dinv1``,
    the coarsest restriction (``r1`` (n2, bs * nb_loc) or the superbrick
    chunk ``rst1`` (bs2, win, nb2c)) and the replicated ``Ainv`` and
    ``fid2``."""

    def __init__(self, **bufs):
        super().__init__()
        for name, t in bufs.items():
            self.register_buffer(name, t)


class ShardedStructured(torch.nn.Module):
    """A StructuredHierarchy split over ``mesh`` (``shard_structured``).
    Its buffers live on their shards' devices; it is placed by its mesh,
    not moved with ``.to``.  ``mid`` holds one MidBundle per distinct
    device for the replicated mid, else is None."""

    def __init__(self, st: StructShardStatic, mesh: ShardMesh, shards,
                 mid=None):
        super().__init__()
        self.st, self.mesh = st, mesh
        self.shards = torch.nn.ModuleList(shards)
        self.mid = torch.nn.ModuleList(mid) if mid is not None else None
        self.n = int(np.prod(st.geo.nodes))

    # -- sharded buffers and layouts ------------------------------------
    def _op(self, name: str) -> list:
        """Each shard's slab operator ``name`` (``A0`` or ``A0s``)."""
        return [DIA(getattr(s, f"{name}_vals"), self.st.offsets,
                    self.st.real) for s in self.shards]

    def pad(self, x: ShardTensor) -> ShardTensor:
        return ShardTensor([F.pad(p, (self.st.halo, self.st.halo))
                            for p in x])

    def unpad(self, xh: ShardTensor) -> ShardTensor:
        h, real = self.st.halo, self.st.real
        return ShardTensor([p[h:h + real] for p in xh])

    def halo_fill(self, xh: ShardTensor) -> ShardTensor:
        """Write the neighbours' planes next to each slab into its halo,
        in place: below the slab's first plane its left neighbour's plane
        before the shared one, above its last plane its right
        neighbour's after the shared one; zeros at the chain's ends.  The
        rest of the halo is left as it is: zero from the pad and from
        the kernels' outputs."""
        h, p, real = self.st.halo, self.st.plane, self.st.real
        left = self.mesh.ppermute_right(
            [x[h + real - 2 * p:h + real - p] for x in xh])
        right = self.mesh.ppermute_left([x[h + p:h + 2 * p] for x in xh])
        for x, lo, hi in zip(xh, left, right):
            x[h - p:h].copy_(lo)
            x[h + real:h + real + p].copy_(hi)
        return xh

    # -- fine level -----------------------------------------------------
    def matvec(self, x: ShardTensor) -> ShardTensor:
        """y = A x, the f32 PCG operator, slab by slab."""
        xh = self.halo_fill(self.pad(x))
        return self.unpad(ShardTensor(
            [stencil_h("spmv", A, v) for A, v in zip(self._op("A0"), xh)]))

    def dot(self, a: ShardTensor, b: ShardTensor) -> ShardTensor:
        """(a, b) with each shared plane counted once (it is the right
        neighbour's, but on the last shard), summed with ``psum``."""
        cut = (self.st.sp1 - 1) * self.st.plane
        parts = []
        for d, (x, y) in enumerate(zip(a, b)):
            own = torch.dot(x[:cut], y[:cut])
            if d == self.mesh.size - 1:
                own = own + torch.dot(x[cut:], y[cut:])
            parts.append(own)
        return self.mesh.psum(parts)

    def _smooth(self, A0s, xh, bh) -> ShardTensor:
        for tau in self.st.taus0:
            xh = self.halo_fill(xh)
            xh = ShardTensor([stencil_h("root", A, x, b, s.dinv0h, tau)
                              for A, x, b, s in zip(A0s, xh, bh,
                                                    self.shards)])
        return xh

    def _slab_geo(self):
        BX, BY, BZ = self.st.geo.bricks
        return (self.st.bxl, BY, BZ), self.st.geo.brick_elems

    def apply_R(self, res: ShardTensor) -> ShardTensor:
        return ShardTensor([window_R(s.Rst, r, *self._slab_geo())
                            for s, r in zip(self.shards, res)])

    def apply_P(self, xc: ShardTensor) -> ShardTensor:
        """Window P on each slab, then each shard's first plane is its
        left neighbour's last."""
        p = self.st.plane
        y = [window_P(s.Rst, x, *self._slab_geo(), ranges=s.Rst_rng)
             for s, x in zip(self.shards, xc)]
        recv = self.mesh.ppermute_right([v[-p:] for v in y])
        for v, r in zip(y[1:], list(recv)[1:]):
            v[:p].copy_(r)
        return ShardTensor(y)

    # -- mid level ------------------------------------------------------
    def _mid_matvec(self, x1: ShardTensor) -> ShardTensor:
        """The brick-block mid matvec on the brick-layer split, with
        one brick layer exchanged a side; x rounds through the blocks'
        dtype as in the single-card matvec."""
        st = self.st
        bs, bxl = st.bs, st.bxl
        _, BY, BZ = st.geo.bricks
        x4 = [x.view(bs, bxl, BY, BZ) for x in x1]
        lsh = self.mesh.ppermute_right([x[:, -1:] for x in x4])
        rsh = self.mesh.ppermute_left([x[:, :1] for x in x4])
        out = []
        for s, x, lo, hi in zip(self.shards, x4, lsh, rsh):
            xp = F.pad(torch.cat([lo, x, hi], 1), (1, 1, 1, 1))
            xs = torch.stack([
                xp[:, 1 + dx:1 + dx + bxl, 1 + dy:1 + dy + BY,
                   1 + dz:1 + dz + BZ] for dx, dy, dz in st.doffs]) \
                .reshape(len(st.doffs), bs, -1).to(s.blocks1.dtype)
            out.append((s.blocks1.float() * xs[:, None].float())
                       .sum((0, 2)).reshape(-1))
        return ShardTensor(out)

    def _coarsest_sb(self, r1v: ShardTensor) -> ShardTensor:
        """The superbrick coarsest correction: each shard contracts its
        chunk of superbricks of the all-gathered mid residual, the
        coarsest vector is all-gathered and solved with the replicated
        inverse, the adjoint contraction gathered back and sliced to the
        shard's bricks (the single-card apply_R1 / P1 arithmetic)."""
        st, P = self.st, self.mesh.size
        bs, bs2, nb2c, bxl = st.bs, st.bs2, st.nb2c, st.bxl
        BX, BY, BZ = st.geo.bricks
        SX, SY, SZ = st.supers
        sx, sy, sz = BX // SX, BY // SY, BZ // SZ
        NB2 = SX * SY * SZ
        chunk = [slice(d * nb2c, (d + 1) * nb2c) for d in range(P)]
        g = self.mesh.all_gather([r.view(bs, st.nb_loc) for r in r1v], 1)
        rc2l = []
        for d, (s, gd) in enumerate(zip(self.shards, g)):
            W = gd.reshape(bs, SX, sx, SY, sy, SZ, sz) \
                .permute(0, 2, 4, 6, 1, 3, 5).reshape(bs * sx * sy * sz, NB2)
            Wl = F.pad(W, (0, P * nb2c - NB2))[:, chunk[d]]
            rc2l.append((s.rst1.float() * Wl[None].float()).sum(1))
        rc2 = self.mesh.all_gather(rc2l, 1)            # (bs2, P, nb2c)
        wl_out = []
        for d, (s, r) in enumerate(zip(self.shards, rc2)):
            rc2f = r.reshape(bs2, P * nb2c)[:, :NB2].reshape(-1)
            y2p = torch.zeros_like(rc2f)
            y2p[s.fid2] = s.Ainv.float() @ rc2f[s.fid2]
            y2l = F.pad(y2p.view(bs2, NB2), (0, P * nb2c - NB2))[:, chunk[d]]
            wl_out.append((s.rst1.float() * y2l[:, None, :].float()).sum(0))
        wf = self.mesh.all_gather(wl_out, 1)            # (win, P, nb2c)
        out = []
        for d, w in enumerate(wf):
            xf = w.reshape(-1, P * nb2c)[:, :NB2] \
                .reshape(bs, sx, sy, sz, SX, SY, SZ) \
                .permute(0, 4, 1, 5, 2, 6, 3).reshape(bs, BX, BY, BZ)
            out.append(xf[:, d * bxl:(d + 1) * bxl].reshape(-1))
        return ShardTensor(out)

    def _coarsest_dense(self, r1v: ShardTensor) -> ShardTensor:
        """Dense R1, its columns split: Ainv psum(R1_d r1v), then each
        shard's R1_d^T of it."""
        part = [s.r1.float() @ v for s, v in zip(self.shards, r1v)]
        tot = self.mesh.psum(part)
        return ShardTensor([s.r1.float().T @ (s.Ainv.float() @ t)
                            for s, t in zip(self.shards, tot)])

    def _mid_distributed(self, b1: ShardTensor) -> ShardTensor:
        dinv1 = ShardTensor([s.dinv1 for s in self.shards])
        x1 = torch.zeros_like(b1)
        for tau in self.st.taus1:
            x1 = x1 + dinv1 * (b1 - self._mid_matvec(x1)) * tau
        r1v = b1 - self._mid_matvec(x1)
        x1 = x1 + (self._coarsest_sb(r1v) if self.st.supers is not None
                   else self._coarsest_dense(r1v))
        for tau in self.st.taus1:
            x1 = x1 + dinv1 * (b1 - self._mid_matvec(x1)) * tau
        return x1

    def _mid_replicated(self, rc: ShardTensor) -> ShardTensor:
        """The all-gathered restricted residual through the hierarchy's
        own mid_correct, once a device; each shard slices its bricks."""
        st, P = self.st, self.mesh.size
        mids = {m.dinv1.device: m for m in self.mid}
        g = self.mesh.all_gather([r.view(st.bs, st.nb_loc) for r in rc], 1)
        xc = self.mesh.per_device(
            lambda t: mids[t.device].mid_correct(t.reshape(-1)), g)
        return ShardTensor([x.view(st.bs, P, st.nb_loc)[:, d].reshape(-1)
                            for d, x in enumerate(xc)])

    # -- the cycle ------------------------------------------------------
    def vcycle(self, b: ShardTensor) -> ShardTensor:
        """One V-cycle from a zero initial guess on the closed-slab
        vectors (the JAX ``_vcycle_blk``)."""
        A0s = self._op("A0s")
        bh = self.pad(b)
        xh = self._smooth(A0s, torch.zeros_like(bh), bh)
        xh = self.halo_fill(xh)
        res = self.unpad(ShardTensor([stencil_h("residual", A, x, bb)
                                      for A, x, bb in zip(A0s, xh, bh)]))
        rc = self.apply_R(res)
        x1 = (self._mid_replicated(rc) if self.mid is not None
              else self._mid_distributed(rc))
        xh = xh + self.pad(self.apply_P(x1))
        return self.unpad(self._smooth(A0s, xh, bh))


def shard_structured(h: StructuredHierarchy, mesh: ShardMesh,
                     mid_replicated: Optional[bool] = None
                     ) -> ShardedStructured:
    """Split a three-level StructuredHierarchy into x-slabs over
    ``mesh``.  ``mid_replicated`` None distributes the mid level where
    the full brick blocks ``A1_blocks`` and a coarsest restriction (R1
    or Rst1) exist, else replicates it (an ``hbm_frugal`` or dense-mid
    hierarchy); True replicates it; False demands the distributed mid.
    Raises ValueError unless P divides BX, the hierarchy has three
    levels and its f32 PCG operator is stored diagonals."""
    P = mesh.size
    geo = h.geo
    BX, BY, BZ = geo.bricks
    bx = geo.brick_elems[0]
    _, NYn, NZn = geo.nodes
    if BX % P:
        raise ValueError(f"{P} shards do not divide the {BX} brick layers "
                         "along x")
    if h.levels != 3:
        raise ValueError(f"the sharded solve takes a three-level "
                         f"hierarchy, got {h.levels} levels")
    A0 = h.A0
    if not isinstance(A0, DIA):
        raise ValueError("the sharded solve needs the f32 PCG operator as "
                         "stored diagonals, not matrix-free")
    can_distribute = h.A1_blocks is not None and (
        h.R1 is not None or h.Rst1 is not None)
    if mid_replicated is None:
        mid_replicated = not can_distribute
    if not mid_replicated and not can_distribute:
        raise ValueError("the distributed mid needs the full brick blocks "
                         "A1_blocks and a dense or superbrick coarsest "
                         f"restriction (mid route {h.mid_route})")
    # a matrix-free smoother twin: the stored f32 operator smooths
    A0s = h.A0s if isinstance(h.A0s, DIA) else None
    plane, bxl = NYn * NZn, BX // P
    slab = bxl * bx
    nb_loc = bxl * BY * BZ
    bs, n2, NB = h.bs, int(h.Ainv.shape[0]), geo.num_bricks
    halo = A0.halo
    real = (slab + 1) * plane
    supers, bs2, nb2c = None, 0, 0
    if not mid_replicated and h.Rst1 is not None:
        supers = h.supers
        bs2, _, NB2 = h.Rst1.shape
        nb2c = -(-NB2 // P)
        rst1_p = F.pad(h.Rst1, (0, P * nb2c - NB2))
    if not mid_replicated:
        ainv, fid2 = mesh.replicate(h.Ainv), (
            mesh.replicate(h.flat_id2) if supers is not None else None)
    shards = []
    for d, dev in enumerate(mesh.devices):
        lo = d * slab * plane
        rows = slice(lo, lo + real)
        cols = slice(d * nb_loc, (d + 1) * nb_loc)

        def put(t):
            return t.contiguous().to(dev)

        bufs = dict(A0_vals=put(A0.vals[:, rows]))
        bufs.update(
            A0s_vals=(put(A0s.vals[:, rows]) if A0s is not None
                      else bufs["A0_vals"]),
            dinv0h=put(F.pad(h.dinv0h[halo + lo:halo + lo + real],
                             (halo, halo))),
            Rst=put(h.Rst[:, :, cols]), Rst_rng=put(h.Rst_rng[:, :, cols]))
        if not mid_replicated:
            bufs.update(
                blocks1=put(h.A1_blocks[..., cols]),
                dinv1=put(h.dinv1.view(bs, NB)[:, cols].reshape(-1)),
                Ainv=ainv[d])
            if supers is not None:
                bufs.update(rst1=put(rst1_p[:, :, d * nb2c:(d + 1) * nb2c]),
                            fid2=fid2[d])
            else:
                bufs["r1"] = put(h.R1.view(n2, bs, NB)[:, :, cols]
                                 .reshape(n2, bs * nb_loc))
        shards.append(_Shard(**bufs))
    st = StructShardStatic(
        geo=geo, ndev=P, plane=plane, sp1=slab + 1, halo=halo,
        offsets=tuple(A0.offsets), doffs=h.doffs, bs=bs, nb_loc=nb_loc,
        taus0=h.taus0, taus1=h.taus1, supers=supers, bs2=bs2,
        nb2c=nb2c)
    mid = ([MidBundle(h).to(dev) for dev in mesh.unique] if mid_replicated
           else None)
    return ShardedStructured(st, mesh, shards, mid)


def mid_bytes_per_device(hs: ShardedStructured) -> dict:
    """Mid-level storage a device holds: ``sharded``, one shard's split
    mid buffers (blocks, dinv1, R1 columns or superbrick chunk);
    ``replicated``, what every device holds whole (the coarsest inverse
    and index map, or the replicated mid bundle)."""
    s0 = hs.shards[0]
    sharded = sum(t.numel() * t.element_size()
                  for t in (getattr(s0, n, None) for n in
                            ("blocks1", "dinv1", "r1", "rst1"))
                  if t is not None)
    held = (list(hs.mid[0].buffers()) if hs.mid is not None
            else [t for t in (s0.Ainv, getattr(s0, "fid2", None))
                  if t is not None])
    replicated = sum(t.numel() * t.element_size() for t in held)
    return {"sharded": sharded, "replicated": replicated,
            "per_device": sharded + replicated}


# ---------------------------------------------------------------------------
# vectors and solves


def scatter_fine(hs: ShardedStructured, b) -> ShardTensor:
    """Flat (n,) fine vector -> the shards' closed-slab f32 vectors."""
    st = hs.st
    b = torch.as_tensor(b).to(torch.float32)
    slab = st.sp1 - 1
    return hs.mesh.put([b[d * slab * st.plane:d * slab * st.plane + st.real]
                        for d in range(st.ndev)])


def gather_fine(hs: ShardedStructured, xs: ShardTensor) -> torch.Tensor:
    """The shards' closed-slab vectors -> flat (n,) on the first
    shard's device (a shared plane from the right-hand shard)."""
    st = hs.st
    slab = st.sp1 - 1
    dev = xs.device
    out = torch.empty(hs.n, dtype=xs.dtype, device=dev)
    for d, x in enumerate(xs):
        lo = d * slab * st.plane
        out[lo:lo + st.real] = x.to(dev)
    return out


def _graph_ok(hs: ShardedStructured, graph: bool) -> bool:
    on_card = hs.mesh.devices[0].type == "cuda"
    if graph and on_card and not hs.mesh.one_device:
        raise ValueError("a captured graph runs on one card: pass "
                         "graph=False on a mesh of several devices")
    return graph


def make_struct_sharded_vcycle(hs: ShardedStructured, graph: bool = True):
    """z = B^-1 b on sharded vectors; on a mesh of one card a replay of
    its captured V-cycle graph unless ``graph=False``."""
    graph = _graph_ok(hs, graph)
    return lambda b: graphed(hs, hs.vcycle, b.to(torch.float32), graph)


def make_struct_sharded_pcg(hs: ShardedStructured, rel_tol: float = 1e-6,
                            max_iter: int = 200, graph: bool = True):
    """PCG (the MFEM CGSolver loop of solve/device_pcg.PCGRunner) with the
    sharded matvec, V-cycle and dot.  Returns ``solve(b,
    rel_tol_override=None) -> (x, iterations)``; a new tolerance is a
    new value of the runner's state, not a new capture."""
    graph = _graph_ok(hs, graph)

    def solve(b: ShardTensor, rel_tol_override: Optional[float] = None):
        rt = rel_tol if rel_tol_override is None else rel_tol_override
        x, it, _ = pcg(hs, hs.matvec, hs.vcycle, b.to(torch.float32),
                       rel_tol=rt, max_iter=max_iter, graph=graph,
                       dot=hs.dot)
        return x, it

    return solve
