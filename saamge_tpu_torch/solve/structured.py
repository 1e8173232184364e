"""Structured (brick) hierarchy of the flagship solve, in PyTorch.

Port of saamge_tpu/solve/structured.py on the flat fine layout: two or
three levels on a Cartesian brick partitioning, bf16 (or f32) smoother
twin, tent blocks and mid operator, and an f32 PCG operator.  One
three-level V-cycle of the flagship configuration runs

  fine pre-smoothing sweep + residual   (ops/wavefront.py, kernel)
  tent restriction R                    (ops/window.py, kernel)
  mid pre-chain + residual              (ops/midsmooth.py, kernel)
  superbrick restriction, dense coarsest inverse, prolongation (torch)
  mid post-chain                        (ops/midsmooth.py, kernel)
  tent prolongation P                   (ops/window.py, kernel)
  fine post-smoothing sweep             (ops/wavefront.py, kernel)

and PCG's operator is the f32 stencil matvec (ops/stencil.py, kernel).
The mid chains keep the operator resident in shared memory; a mid
operator whose tiles do not fit one wave of the card, or
``mid_resident=False``, takes the packed passes of the capacity
configuration instead, a choice made at compile (``mid_buffers``).

The other branches of the JAX compile_structured: a two-level
hierarchy, whose dense coarsest inverse follows the tent directly; a
dense coarsest restriction ``R1`` where no superbrick grid is given; and
the dense mid format (``mid_format='dense'``: the mid operator a dense
matrix on the unpadded coarse dofs, its products plain bf16-in / f32-out
matrix products).  The coarsest inverse is the host f64 inverse up to n
= 4096 and a Cholesky factorization on the hierarchy's device above
(``_device_spd_inverse``).

The full-capacity configuration (``mfree`` with ``hbm_frugal``, the
JAX package's ``run_capacity.py`` flags) keeps no stored fine operator
and no full mid blocks on the device:

  fine smoothing: one matrix-free chain + residual     (ops/mfree.py)
  mid smoothing: one packed pass per root + residual    (ops/midmv.py)
  PCG operator: the f32 matrix-free pass                (ops/mfree.py)

with the same tent R/P and coarsest level (its inverse optionally
bf16).  With ``use_pallas_contract`` (f32 tent blocks) the tent R/P are
box extraction + ``contract_R`` and ``contract_P`` + the box fold
(ops/contract.py) in place of the window kernels.  The host builders
are numpy re-implementations of the JAX module's (which imports jax and
so cannot be used here).

Fine vectors are flat and haloed (ops/sparse.DIA), not the TPU's
(rows, 128) tiling; the z-lane layout is not ported."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from saamge_tpu_torch._device import card_or_cpu, is_cuda
from saamge_tpu_torch.ops.contract import (SlotLists, contract_P,
                                           contract_R, extract_boxes,
                                           fold_boxes, fold_index,
                                           slot_lists)
from saamge_tpu_torch.ops.mfree import MatrixFreeQ1, mfree_chain, mfree_h
from saamge_tpu_torch.ops.midmv import midmv, pack_blocks
from saamge_tpu_torch.ops.midsmooth import (MidTileMisfit, MidTilePlan,
                                            card_limits, mid_chain,
                                            mid_tile_plan, pack_tiles)
from saamge_tpu_torch.ops.smoother import inv_taus_f32
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.stencil import stencil_h
from saamge_tpu_torch.ops.wavefront import wavefront_smooth
from saamge_tpu_torch.ops.window import slot_ranges, window_P, window_R
from saamge_tpu_torch.solve.device_pcg import graphed, pcg
from saamge_tpu_torch.utils.logging import TIMERS, sa_print

SPD_HOST_MAX = 4096     # above this size the coarsest inverse is factored
SPD_CHUNK = 2048        # identity columns per triangular solve


# ---------------------------------------------------------------------------
# host-side builders (numpy)


@dataclasses.dataclass(frozen=True)
class BrickGeometry:
    """Static geometry of a brick-partitioned structured hex mesh.

    Nodes per dim are (BX*bx+1, BY*by+1, BZ*bz+1); fine dof id is
    x-major lexicographic (fem/mesh.py hex_mesh vid)."""

    bricks: Tuple[int, int, int]       # (BX, BY, BZ)
    brick_elems: Tuple[int, int, int]  # (bx, by, bz)

    @property
    def nodes(self):
        (BX, BY, BZ), (bx, by, bz) = self.bricks, self.brick_elems
        return (BX * bx + 1, BY * by + 1, BZ * bz + 1)

    @property
    def num_bricks(self):
        return int(np.prod(self.bricks))

    @property
    def box(self):
        bx, by, bz = self.brick_elems
        return (bx + 1) * (by + 1) * (bz + 1)


def coarse_brick_numbering(rels, mis_numcoarsedof: np.ndarray):
    """Group coarse dofs by the master brick of their MIS (master = min
    containing AE) and assign slots; returns (brick, slot, bs, counts)
    per coarse dof (reference aggregates.cpp:1610-1730)."""
    nm = rels.num_mises
    ncd = np.asarray(mis_numcoarsedof, dtype=np.int64)
    m2a = rels.mis_to_AE
    sizes = m2a.row_sizes()
    master = np.full(nm, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(master, np.repeat(np.arange(nm), sizes), m2a.indices)
    cd_mis = np.repeat(np.arange(nm), ncd)
    cd_brick = master[cd_mis]
    counts = np.bincount(cd_brick, minlength=rels.nparts)
    bs = int(counts.max())
    order = np.argsort(cd_brick, kind="stable")
    slot = np.empty(len(cd_mis), dtype=np.int64)
    starts = np.zeros(rels.nparts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot[order] = np.arange(len(cd_mis)) - starts[cd_brick[order]]
    return cd_brick, slot, bs, counts


def build_structured_interp(rels, P: sp.csr_matrix,
                            mis_numcoarsedof: np.ndarray,
                            geo: BrickGeometry):
    """Dense per-brick tent blocks: returns (Rst (NB, bs, box) f32,
    cd_brick, slot, bs) with Rst[p, s, boxpos] = P[fine dof at boxpos of
    brick p's closed box, coarse dof (p, s)]."""
    (BX, BY, BZ) = geo.bricks
    (bx, by, bz) = geo.brick_elems
    NXn, NYn, NZn = geo.nodes
    cd_brick, slot, bs, _ = coarse_brick_numbering(rels, mis_numcoarsedof)
    Pc = P.tocsc()
    n_c = Pc.shape[1]
    if len(cd_brick) != n_c:
        raise ValueError(f"{len(cd_brick)} numbered coarse dofs, P has {n_c}")
    rows = Pc.indices
    col_of = np.repeat(np.arange(n_c), np.diff(Pc.indptr))
    ix, rem = np.divmod(rows, NYn * NZn)
    iy, iz = np.divmod(rem, NZn)
    pb = cd_brick[col_of]
    pz = pb % BZ
    py = (pb // BZ) % BY
    px = pb // (BY * BZ)
    u, v, w = ix - px * bx, iy - py * by, iz - pz * bz
    ok = ((u >= 0) & (u <= bx) & (v >= 0) & (v <= by)
          & (w >= 0) & (w <= bz))
    if not np.all(ok):
        raise ValueError("tent column escapes its master brick's closed "
                         "box: partitioning is not brick-structured")
    boxpos = (u * (by + 1) + v) * (bz + 1) + w
    Rst = np.zeros((geo.num_bricks, bs, geo.box), dtype=np.float32)
    Rst[pb, slot[col_of], boxpos] = Pc.data
    return Rst, cd_brick, slot, bs


def build_structured_interp2(rels1, P1: sp.csr_matrix,
                             mis_numcoarsedof1: np.ndarray,
                             geo: BrickGeometry, supers,
                             cd_brick: np.ndarray, slot: np.ndarray,
                             bs: int):
    """Block-diagonal level-2 tent blocks over superbricks: returns
    (Rst1 (bs2, win, NB2) f32, cd2_brick, slot2, bs2), win = bs*sx*sy*sz
    with window position ((s*sx+lx)*sy+ly)*sz+lz."""
    (BX, BY, BZ) = geo.bricks
    SX, SY, SZ = supers
    if BX % SX or BY % SY or BZ % SZ:
        raise ValueError("supers must divide the brick grid evenly")
    sx, sy, sz = BX // SX, BY // SY, BZ // SZ
    cd2_brick, slot2, bs2, _ = coarse_brick_numbering(rels1,
                                                      mis_numcoarsedof1)
    NB2 = SX * SY * SZ
    Pc = P1.tocsc()
    n2 = Pc.shape[1]
    if len(cd2_brick) != n2:
        raise ValueError(f"{len(cd2_brick)} numbered level-2 dofs, P1 has "
                         f"{n2}")
    rows = Pc.indices
    col_of = np.repeat(np.arange(n2), np.diff(Pc.indptr))
    p, s = cd_brick[rows], slot[rows]
    pz, py, px = p % BZ, (p // BZ) % BY, p // (BY * BZ)
    S = cd2_brick[col_of]
    Sz, Sy, Sx = S % SZ, (S // SZ) % SY, S // (SY * SZ)
    lx, ly, lz = px - Sx * sx, py - Sy * sy, pz - Sz * sz
    ok = ((lx >= 0) & (lx < sx) & (ly >= 0) & (ly < sy)
          & (lz >= 0) & (lz < sz))
    if not np.all(ok):
        raise ValueError("level-2 tent column escapes its master "
                         "superbrick: the 3rd-level partitioning is not "
                         "superbrick-structured")
    winpos = ((s * sx + lx) * sy + ly) * sz + lz
    Rst1 = np.zeros((bs2, bs * sx * sy * sz, NB2), dtype=np.float32)
    Rst1[slot2[col_of], winpos, S] = Pc.data
    return Rst1, cd2_brick, slot2, bs2


def brick_block_from_csr(Ac: sp.csr_matrix, cd_brick: np.ndarray,
                         slot: np.ndarray, bs: int, bricks):
    """Mid operator in the slot-major padded brick-block form: returns
    (blocks (k, bs, bs, NB) f64, doffs, rects) with blocks[k, s1, s2, p]
    = Ac[(p, s1), (p + doffs[k], s2)] and rects[k] = (r1, r2) the
    used-slot rectangle of offset k, made direction-symmetric."""
    BX, BY, BZ = bricks
    coo = Ac.tocoo()
    p, q = cd_brick[coo.row], cd_brick[coo.col]
    dx = q // (BY * BZ) - p // (BY * BZ)
    dy = (q // BZ) % BY - (p // BZ) % BY
    dz = q % BZ - p % BZ
    if max(np.abs(dx).max(), np.abs(dy).max(), np.abs(dz).max()) > 1:
        raise ValueError("coarse coupling beyond brick neighbors: "
                         "partitioning is not brick-structured")
    dkey = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
    used = np.unique(dkey)
    kmap = np.full(27, -1, dtype=np.int64)
    kmap[used] = np.arange(len(used))
    NB = BX * BY * BZ
    blocks = np.zeros((len(used), bs, bs, NB), dtype=np.float64)
    s1a, s2a = slot[coo.row], slot[coo.col]
    ki = kmap[dkey]
    np.add.at(blocks, (ki, s1a, s2a, p), coo.data)
    doffs = tuple((int(u) // 9 - 1, (int(u) // 3) % 3 - 1, int(u) % 3 - 1)
                  for u in used)
    rects = [(int(s1a[ki == j].max()) + 1, int(s2a[ki == j].max()) + 1)
             for j in range(len(used))]
    dmap = {d: j for j, d in enumerate(doffs)}
    for j, d in enumerate(doffs):
        jn = dmap.get((-d[0], -d[1], -d[2]))
        if jn is not None:
            rects[j] = (max(rects[j][0], rects[jn][1]),
                        max(rects[j][1], rects[jn][0]))
    return blocks, doffs, tuple(rects)


def mid_buffers(A1_blocks: torch.Tensor, rects, bricks, device,
                resident: bool | None = None) -> dict:
    """The mid operator's buffers beside its full blocks: the resident
    chain's tile-major packing (``A1_tiles``) and its launch plan
    (``mid_plan``) when its tiles fit one resident wave of ``device``'s
    card (ops/midsmooth.mid_tile_plan; for a CPU device the H100's), else
    the packed rectangles (``A1_packed``) of the one-pass-per-root route.
    ``resident`` None chooses by shape, logged; True demands the resident
    chain (a misfit raises MidTileMisfit); False takes the packed route.
    The values are those of ``A1_blocks``, exactly."""
    if resident is not False:
        try:
            plan = mid_tile_plan(bricks, A1_blocks.shape[1], rects,
                                 *card_limits(device),
                                 A1_blocks.element_size())
        except MidTileMisfit as e:
            if resident:
                raise
            sa_print(1, f"mid operator: packed passes, not the resident "
                     f"chain ({e})")
        else:
            return {"A1_blocks": A1_blocks, "mid_plan": plan,
                    "A1_tiles": pack_tiles(A1_blocks, rects, plan.tile)}
    return {"A1_blocks": A1_blocks, "A1_packed": torch.cat(
        [A1_blocks[k, :r1, :r2].reshape(-1)
         for k, (r1, r2) in enumerate(rects)])}


def _device_spd_inverse(Ac: np.ndarray, device="cpu") -> torch.Tensor:
    """Explicit f32 inverse of the SPD coarsest operator ``Ac`` (a dense
    f64 host array), by the rule of the JAX package's function of this
    name: up to n = 4096 the host f64 inverse rounded to f32 (a CPU
    tensor); above, ``Ac`` rounded to f32 and factored on ``device``
    (``torch.linalg.cholesky_ex``, lower), freed, and the factor solved
    against column chunks of the identity, 2048 wide (one full-width
    solve makes n^2-sized temporaries).  Where the f32 matrix is not
    positive definite this raises with the failed pivot; the JAX
    ``cho_factor`` returns NaN there."""
    n = Ac.shape[0]
    if n <= SPD_HOST_MAX:
        return torch.as_tensor(np.linalg.inv(Ac)).to(torch.float32)
    with TIMERS.phase("compile.coarsest_inverse"):
        A = torch.as_tensor(Ac, dtype=torch.float32).to(device)
        L, info = torch.linalg.cholesky_ex(A)
        del A
        if int(info):
            raise np.linalg.LinAlgError(
                f"coarsest operator ({n} x {n}, rounded to f32) is not "
                f"positive definite: its leading minor of order "
                f"{int(info)} is not")
        out = torch.empty(n, n, dtype=torch.float32, device=L.device)
        for j in range(0, n, SPD_CHUNK):
            w = min(SPD_CHUNK, n - j)
            E = torch.zeros(n, w, dtype=torch.float32, device=L.device)
            E[j:j + w] = torch.eye(w, dtype=torch.float32, device=L.device)
            out[:, j:j + w] = torch.cholesky_solve(E, L)
        del L, E
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


# ---------------------------------------------------------------------------
# device-side hierarchy


def _widened(M: torch.Tensor) -> torch.Tensor:
    """M in f32; a copy made for that is counted in
    ``coarsest.widened_bytes``."""
    if M.dtype == torch.float32:
        return M
    TIMERS.count("coarsest.widened_bytes", M.numel() * 4)
    return M.to(torch.float32)


class StructuredHierarchy(torch.nn.Module):
    """2- or 3-level structured hierarchy.  Arrays are buffers, so
    ``.to(dev)`` moves it; on a CUDA device every kernel of the cycle is
    a hand-written one, on the CPU each runs its plain torch version.

    The PCG operator A0 (f32) and the smoother twin A0s are each stored
    diagonals (buffer ``<name>_vals``, (k, n), ops/sparse.DIA) or
    matrix-free (buffers ``<name>_c`` and ``<name>_m``, the haloed
    coefficient field and node mask, ops/mfree.MatrixFreeQ1).  Other
    fine-level buffers: dinv0h haloed fine smoother scaling; Rst (bs,
    box, NB) tent blocks and Rst_rng (2, box, NB) their nonzero slot
    ranges; flat_id the real-dof ids in the slot-major padded layout.
    With ``contract`` the tent R/P run as box contractions
    (ops/contract.py) instead of the window kernels: slot_order,
    slot_start, slot_val and slot_node are contract R's by-slot node
    lists (ops/contract.slot_lists, with the length classes
    ``slot_classes``), and fold_idx (n,) int32 is the box fold's gather
    index.

    Two levels (``levels == 2``): no mid operator; Ainv is the f32
    inverse of the coarse operator on the real dofs, (n_c, n_c).

    Three levels: the mid operator runs by one of three routes
    (``mid_route``): "resident", the chain kernel on ``A1_tiles``, the
    tile-major packing of the full blocks ``A1_blocks`` (k1, bs, bs, NB)
    in tiles of ``mid_plan.tile`` bricks (ops/midsmooth.pack_tiles),
    launched by ``mid_plan``, with the plain chain on ``A1_blocks``;
    "packed", one root pass per root over the packed rectangles
    ``A1_packed`` (ops/midmv.py), with ``A1_blocks`` kept where the
    hierarchy is not hbm_frugal; or "dense", the dense (n1, n1) operator
    ``A1_dense`` on the real coarse dofs.  dinv1 is the mid scaling:
    (bs*NB,) with 0 on padding slots, or (n1,) beside ``A1_dense``.  The
    coarsest restriction is either the superbrick tent blocks Rst1 (bs2,
    win, NB2), with flat_id2 the real-dof ids of their padded layout, or
    the dense R1, (n2, bs*NB) (zero padding columns) or (n2, n1) beside
    ``A1_dense``; Ainv is the coarsest inverse (f32 or bf16)."""

    def __init__(self, *, A0, A0s, dinv0, taus0, Rst, flat_id, Ainv,
                 geo: BrickGeometry, doffs=(), rects=(), dinv1=None,
                 taus1=(), Rst1=None, flat_id2=None, supers=None, R1=None,
                 A1_blocks=None, A1_tiles=None,
                 mid_plan: MidTilePlan | None = None, A1_packed=None,
                 A1_dense=None, contract: bool = False):
        super().__init__()
        self.contract = bool(contract)
        mids = sum(a is not None for a in (A1_tiles, A1_packed, A1_dense))
        if mids > 1:
            raise ValueError("give at most one of A1_tiles, A1_packed and "
                             "A1_dense")
        self.levels = 3 if mids else 2
        if self.levels == 2 and any(a is not None for a in (
                A1_blocks, dinv1, R1, Rst1, flat_id2)):
            raise ValueError("a two-level hierarchy has no mid operator, "
                             "mid scaling or coarsest restriction")
        if self.levels == 3:
            if dinv1 is None:
                raise ValueError("a three-level hierarchy needs dinv1")
            if (R1 is None) == (Rst1 is None):
                raise ValueError("give exactly one of R1 (dense coarsest "
                                 "restriction) and Rst1 (superbrick tent "
                                 "blocks)")
            if Rst1 is not None and (flat_id2 is None or supers is None):
                raise ValueError("the superbrick tent blocks need flat_id2 "
                                 "and supers")
            if A1_dense is not None and R1 is None:
                raise ValueError("the dense mid operator takes the dense R1")
        if A1_tiles is not None and (A1_blocks is None or mid_plan is None):
            raise ValueError("the resident mid chain needs A1_blocks and "
                             "its mid_plan")
        self.mid_plan = mid_plan
        if A0.halo != A0s.halo:
            raise ValueError(f"PCG operator halo {A0.halo} != smoother "
                             f"twin halo {A0s.halo}")
        self.n = int(np.prod(geo.nodes))
        self.geo = geo
        self.supers = (tuple(int(s) for s in supers) if supers is not None
                       else None)
        self.taus0 = tuple(float(t) for t in taus0)
        self.taus1 = tuple(float(t) for t in taus1)
        self.doffs = tuple(tuple(int(c) for c in d) for d in doffs)
        self.rects = tuple((int(a), int(b)) for a, b in rects)
        self.offsets = self.K = None
        for name, op in (("A0", A0), ("A0s", A0s)):
            if op.n != self.n:
                raise ValueError(f"{name} has {op.n} rows, the brick "
                                 f"geometry {self.n} nodes")
            if isinstance(op, DIA):
                self.offsets = tuple(int(o) for o in op.offsets)
                self.register_buffer(f"{name}_vals", op.vals)
            else:
                self.K = op.K
                self.register_buffer(f"{name}_c", op.c_h)
                self.register_buffer(f"{name}_m", op.m_h)
        self.register_buffer("dinv0h", torch.nn.functional.pad(
            dinv0.to(torch.float32), (A0.halo, A0.halo)))
        self.register_buffer("Rst", Rst)
        # the table of the nonzero slots (ops/window.slot_ranges) that
        # window P and both contractions read
        self.register_buffer("Rst_rng", slot_ranges(Rst))
        # contract R's by-slot node lists (ops/contract.slot_lists) and
        # the box fold's gather index (ops/contract.fold_index)
        lists = slot_lists(Rst) if self.contract else None
        for name in SlotLists._fields[:4]:
            self.register_buffer(f"slot_{name}",
                                 getattr(lists, name, None))
        self.slot_classes = lists[4:] if lists is not None else None
        self.register_buffer("fold_idx", fold_index(
            geo.bricks, geo.brick_elems, Rst.device) if self.contract
            else None)
        self.register_buffer("A1_blocks", A1_blocks)
        self.register_buffer("A1_tiles", A1_tiles)
        self.register_buffer("A1_packed", A1_packed)
        self.register_buffer("A1_dense", A1_dense)
        self.register_buffer("dinv1", dinv1.to(torch.float32)
                             if dinv1 is not None else None)
        self.register_buffer("Rst1", Rst1)
        self.register_buffer("R1", R1)
        self.register_buffer("flat_id", flat_id.to(torch.int64))
        self.register_buffer("flat_id2", flat_id2.to(torch.int64)
                             if flat_id2 is not None else None)
        self.register_buffer("Ainv", Ainv)

    # -- operators and layouts -------------------------------------------
    def _fine_op(self, name: str):
        vals = getattr(self, f"{name}_vals", None)
        if vals is not None:
            return DIA(vals, self.offsets, self.n)
        return MatrixFreeQ1(getattr(self, f"{name}_c"),
                            getattr(self, f"{name}_m"), self.K,
                            self.geo.nodes)

    @property
    def A0(self):
        return self._fine_op("A0")

    @property
    def A0s(self):
        return self._fine_op("A0s")

    @property
    def mid_route(self) -> str | None:
        """"resident", "packed" or "dense"; None for two levels."""
        for route, buf in (("resident", self.A1_tiles),
                           ("packed", self.A1_packed),
                           ("dense", self.A1_dense)):
            if buf is not None:
                return route
        return None

    @property
    def bs(self) -> int:
        return int(self.Rst.shape[0])

    @property
    def n_flat(self) -> int:
        return self.bs * self.geo.num_bricks

    def matvec0(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x, the PCG operator (f32 values)."""
        A0 = self.A0
        fn = stencil_h if isinstance(A0, DIA) else mfree_h
        return A0.unpad(fn("spmv", A0, A0.pad(x)))

    @property
    def slot_lists(self) -> SlotLists | None:
        if self.slot_classes is None:
            return None
        return SlotLists(self.slot_order, self.slot_start, self.slot_val,
                         self.slot_node, *self.slot_classes)

    def apply_R(self, res: torch.Tensor) -> torch.Tensor:
        geo = (self.geo.bricks, self.geo.brick_elems)
        if self.contract:
            return contract_R(self.Rst, extract_boxes(res, *geo),
                              lists=self.slot_lists).reshape(-1)
        return window_R(self.Rst, res, *geo)

    def apply_P(self, xc: torch.Tensor) -> torch.Tensor:
        geo = (self.geo.bricks, self.geo.brick_elems)
        if self.contract:
            C = contract_P(self.Rst, xc.view(self.bs, -1),
                           ranges=self.Rst_rng)
            return fold_boxes(C, self.fold_idx)
        return window_P(self.Rst, xc, *geo, ranges=self.Rst_rng)

    # -- coarsest level (plain torch, as the JAX package leaves it to XLA)
    def _super_dims(self):
        (BX, BY, BZ), (SX, SY, SZ) = self.geo.bricks, self.supers
        return (SX, SY, SZ), (BX // SX, BY // SY, BZ // SZ)

    def apply_R1(self, r1: torch.Tensor) -> torch.Tensor:
        """Superbrick tent restriction of a slot-major mid vector:
        (bs * NB,) -> (bs2 * NB2,)."""
        (SX, SY, SZ), (sx, sy, sz) = self._super_dims()
        W = r1.view(self.bs, SX, sx, SY, sy, SZ, sz) \
            .permute(0, 2, 4, 6, 1, 3, 5) \
            .reshape(self.bs * sx * sy * sz, SX * SY * SZ)
        return (self.Rst1.to(torch.float32) * W[None]).sum(1).reshape(-1)

    def apply_P1(self, y2: torch.Tensor) -> torch.Tensor:
        """Adjoint of apply_R1: (bs2 * NB2,) -> (bs * NB,)."""
        (SX, SY, SZ), (sx, sy, sz) = self._super_dims()
        bs2, _, NB2 = self.Rst1.shape
        W = (self.Rst1.to(torch.float32)
             * y2.view(bs2, 1, NB2)).sum(0)
        return W.view(self.bs, sx, sy, sz, SX, SY, SZ) \
            .permute(0, 4, 1, 5, 2, 6, 3).reshape(-1)

    def coarsest_correct(self, r1: torch.Tensor) -> torch.Tensor:
        """P1 Ainv R1 r1 on the mid layout.  A bf16 inverse or R1 is
        widened for the product, as XLA promotes the JAX package's
        mixed-dtype matmuls; the counter ``coarsest.widened_bytes`` of
        utils/logging.TIMERS adds the bytes of those f32 copies."""
        Ainv = _widened(self.Ainv)
        if self.R1 is not None:
            R1 = _widened(self.R1)
            return R1.T @ (Ainv @ (R1 @ r1))
        rc2 = self.apply_R1(r1)
        y2 = torch.zeros_like(rc2)
        y2[self.flat_id2] = Ainv @ rc2[self.flat_id2]
        return self.apply_P1(y2)

    def mid_pass(self, mode: str, x: torch.Tensor, b=None,
                 inv_tau: float = 0.0) -> torch.Tensor:
        """One packed-operator pass (hbm_frugal): A1 x, b - A1 x, or the
        root x + dinv1 (b - A1 x) inv_tau (ops/midmv.py)."""
        return midmv(self.A1_packed, self.doffs, self.rects, self.geo.bricks,
                     self.bs, x, mode, b, self.dinv1, inv_tau)

    def mid_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A1 x of the dense mid operator, as the JAX package's
        ``jnp.dot(A1, x.astype(A1.dtype), preferred_element_type=f32)``:
        x rounded to A1's dtype, the product accumulated and returned in
        f32.  A bf16 A1 on the card is one bf16-in / f32-out cuBLAS
        product (no widened copy of the operator); on the CPU the plain
        form widens both."""
        A1 = self.A1_dense
        xr = x.to(A1.dtype)
        if A1.dtype == torch.float32:
            return A1 @ xr
        if is_cuda(A1, xr):
            return torch.mm(A1, xr[:, None], out_dtype=torch.float32)[:, 0]
        return A1.float() @ xr.float()

    def _dense_correct(self, rc: torch.Tensor) -> torch.Tensor:
        """mid_correct of the dense mid format: the chains on rc's real
        dofs, in the op order of the JAX mid_correct's unpadded branch,
        scattered back into the padded layout."""
        b1 = rc[self.flat_id]
        x1 = torch.zeros_like(b1)
        for it in self.taus1:
            x1 = x1 + self.dinv1 * (b1 - self.mid_matvec(x1)) * it
        x1 = x1 + self.coarsest_correct(b1 - self.mid_matvec(x1))
        for it in self.taus1:
            x1 = x1 + self.dinv1 * (b1 - self.mid_matvec(x1)) * it
        xc = torch.zeros_like(rc)
        xc[self.flat_id] = x1
        return xc

    def mid_correct(self, rc: torch.Tensor) -> torch.Tensor:
        """Pre mid-chain (+ residual), coarsest correction, post
        mid-chain, from the restricted residual in the slot-major padded
        layout."""
        if self.mid_route == "dense":
            return self._dense_correct(rc)
        if self.mid_route == "resident":
            args = (self.A1_blocks, self.A1_tiles, self.mid_plan, self.doffs,
                    self.rects, self.geo.bricks, self.taus1)
            x1, r1 = mid_chain(*args, rc, self.dinv1, torch.zeros_like(rc),
                               emit_res=True)
            x1 = x1 + self.coarsest_correct(r1)
            return mid_chain(*args, rc, self.dinv1, x1)
        # one packed pass per root and one for the residual, each in the
        # op order of the JAX mid_correct
        x1 = torch.zeros_like(rc)
        for it in self.taus1:
            x1 = self.mid_pass("root", x1, rc, it)
        x1 = x1 + self.coarsest_correct(self.mid_pass("residual", x1, rc))
        for it in self.taus1:
            x1 = self.mid_pass("root", x1, rc, it)
        return x1

    def coarse_correct(self, rc: torch.Tensor) -> torch.Tensor:
        """The coarse-grid correction of the restricted residual: two
        levels, the coarsest inverse on the real dofs scattered back into
        the padded layout (the JAX vcycle's two-level branch); three
        levels, mid_correct."""
        if self.levels == 3:
            return self.mid_correct(rc)
        xc = torch.zeros_like(rc)
        xc[self.flat_id] = self.Ainv.to(torch.float32) @ rc[self.flat_id]
        return xc

    def _smooth_h(self, A, bh, xh, emit_res: bool = False):
        """All fine roots (+ the trailing residual) in one launch: the
        sweep kernel for stored diagonals, the matrix-free chain kernel
        for the matrix-free operator (its plain version is the JAX
        package's loop of root passes and a residual pass)."""
        smooth = wavefront_smooth if isinstance(A, DIA) else mfree_chain
        return smooth(A, self.taus0, bh, self.dinv0h, xh,
                      emit_residual=emit_res)

    def vcycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle from a zero initial guess (tg_cycle_atb,
        reference tg.cpp:91, on the structured formats)."""
        A0s = self.A0s
        bh = A0s.pad(b)
        xh, resh = self._smooth_h(A0s, bh, torch.zeros_like(bh),
                                  emit_res=True)
        xc = self.coarse_correct(self.apply_R(A0s.unpad(resh)))
        xh = xh + A0s.pad(self.apply_P(xc))
        xh = self._smooth_h(A0s, bh, xh)
        return A0s.unpad(xh)


@TIMERS.phase("compile")
def compile_structured(ml, geo: BrickGeometry, super_bricks=None,
                       smoother_dtype=torch.bfloat16,
                       rp_dtype=torch.bfloat16,
                       mid_dtype=torch.bfloat16,
                       device="cuda", mfree=None, hbm_frugal: bool = False,
                       ainv_dtype=torch.float32,
                       use_pallas_contract: bool = False,
                       mid_format: str = "brickblock",
                       mid_resident: bool | None = None
                       ) -> StructuredHierarchy:
    """Build the structured hierarchy from a 2- or 3-level host setup
    product on a brick partitioning with a tentative finest P (JAX
    counterpart compile_structured on the flat fine layout, with
    window_contract and wavefront).  ``smoother_dtype``, ``rp_dtype`` and
    ``mid_dtype`` are the storage dtypes of the fine smoother twin, the
    tent blocks (Rst, and Rst1 or R1) and the mid operator; the PCG
    operator is always f32.

    Three levels: ``super_bricks`` (SX, SY, SZ), the superbrick grid of
    the 3rd-level partitioning (with a tentative P1), makes the coarsest
    restriction the per-superbrick tent blocks Rst1 (the flagship
    configuration); None makes it the dense R1 (n2 x n_flat, zero in the
    padding columns).  ``mid_format`` 'brickblock' stores the mid
    operator as per-brick-offset blocks in the slot-major padded layout;
    'dense' as the dense n1 x n1 matrix on the real coarse dofs, with the
    dense n2 x n1 R1 (``super_bricks`` is then ignored).
    ``mid_resident`` (brickblock): None runs the mid chains resident in
    shared memory when their tiles fit one wave of the card, else the
    packed passes; True demands the resident chain (a misfit raises
    MidTileMisfit); False takes the packed passes.

    The coarsest inverse (``_device_spd_inverse``): the host f64 inverse
    up to n = 4096, else a Cholesky factorization on ``device``.
    ``ainv_dtype`` is its storage dtype with three levels; the two-level
    inverse (n_c x n_c, after the tent) is always f32, as in the JAX
    package.

    The capacity options of the JAX compile_structured:
    ``mfree=(em0, c_elem, ess_dofs)`` (when the fine operator factors
    per element as c_e * em0, fem/assemble.py diffusion_factorized)
    makes the smoother twin matrix-free, with its coefficient field in
    ``smoother_dtype``, checked against the operator's diagonal on every
    row.  ``hbm_frugal`` stores a brickblock mid operator as packed
    rectangles only and, with ``mfree``, makes the PCG operator an f32
    matrix-free one: no (k, n) diagonals and no full mid blocks are kept.

    ``use_pallas_contract`` runs the tent R/P as box extraction and the
    contraction kernels (ops/contract.py) instead of the window kernels;
    the JAX configuration pairs it with f32 tent blocks
    (``rp_dtype=torch.float32``).  The hierarchy is built on ``device``
    (the card unless the caller asks for "cpu").

    The call is the phase ``compile`` of utils/logging.TIMERS, its stages
    phases inside it: the fine level (``compile.fine``: the PCG operator
    and the smoother twin, DIA or matrix-free, and the tent blocks Rst),
    the mid level (``compile.mid``: the brick blocks, their packings and
    tiles, or the dense mid), the coarsest restriction
    (``compile.coarse``: the superbrick tent blocks Rst1 or the dense
    R1), the coarsest inverse (``compile.coarsest_inverse``, on the
    Cholesky route only) and the module (``compile.module``: its index
    tables and the copy to ``device``)."""
    device = card_or_cpu(device)
    if len(ml.levels) not in (1, 2):
        raise ValueError("the structured path takes a 2- or 3-level setup "
                         f"(1 or 2 two-grid levels), got {len(ml.levels)}")
    if mid_format not in ("brickblock", "dense"):
        raise ValueError(f"mid_format {mid_format!r}: expected 'brickblock' "
                         "or 'dense'")
    lv0 = ml.levels[0]
    tg0 = lv0.tg_data
    if tg0.smooth_interp:
        raise ValueError("the structured path needs the tentative P")
    pd0 = tg0.poly_data
    if pd0.roots2 is not None and len(pd0.roots2):
        raise ValueError("only single-chain root families are ported")
    t = torch.as_tensor
    with TIMERS.phase("compile.fine"):
        if mfree is None:
            A0 = DIA.from_csr(lv0.A, torch.float32, max_diags=64)
            A0s = DIA(A0.vals.to(smoother_dtype), A0.offsets, A0.n)
        else:
            em0, c_elem, ess_dofs = mfree
            A0s = MatrixFreeQ1.build(c_elem, ess_dofs, em0, geo.nodes,
                                     smoother_dtype, A_csr=lv0.A)
            A0 = (MatrixFreeQ1.build(c_elem, ess_dofs, em0, geo.nodes,
                                     torch.float32) if hbm_frugal
                  else DIA.from_csr(lv0.A, torch.float32, max_diags=64))
        Rst_bm, cd_brick, slot, bs = build_structured_interp(
            lv0.rels, tg0.tent_interp, tg0.interp_data.mis_numcoarsedof,
            geo)
        NB = geo.num_bricks
        flat_id = slot * NB + cd_brick
        fine = dict(
            A0=A0, A0s=A0s, dinv0=t(np.asarray(pd0.dinv, np.float64)),
            taus0=inv_taus_f32(pd0.roots),
            Rst=t(np.ascontiguousarray(Rst_bm.transpose(1, 2, 0)))
            .to(rp_dtype),
            flat_id=t(flat_id), geo=geo, contract=use_pallas_contract)
    Ac1 = tg0.Ac.tocsr()
    if len(ml.levels) == 1:
        Ainv = _device_spd_inverse(np.asarray(Ac1.todense(), np.float64),
                                   device)
        with TIMERS.phase("compile.module"):
            return StructuredHierarchy(Ainv=Ainv, **fine).to(device)

    tg1 = ml.levels[1].tg_data
    dinv1 = np.asarray(tg1.poly_data.dinv, np.float64)

    def dense(M, dtype):
        """f64 host array -> dtype, rounded to f32 first as the JAX
        package's arrays are."""
        return t(np.asarray(M, np.float64)).to(torch.float32).to(dtype)

    with TIMERS.phase("compile.mid"):
        if mid_format == "dense":
            mid = {"A1_dense": dense(Ac1.todense(), mid_dtype)}
        else:
            blocks, doffs, rects = brick_block_from_csr(Ac1, cd_brick, slot,
                                                        bs, geo.bricks)
            dinv1p = np.zeros(NB * bs)
            dinv1p[flat_id] = dinv1
            dinv1 = dinv1p
            if hbm_frugal:
                mid = {"A1_packed": pack_blocks(blocks, rects, mid_dtype)}
            else:
                mid = mid_buffers(dense(blocks, mid_dtype), rects,
                                  geo.bricks, device, resident=mid_resident)
            mid.update(doffs=doffs, rects=rects)
    with TIMERS.phase("compile.coarse"):
        if mid_format == "dense":
            mid["R1"] = dense(tg1.restr.todense(), rp_dtype)
        elif super_bricks is not None:
            if tg1.smooth_interp:
                raise ValueError("the superbrick coarsest restriction needs "
                                 "the tentative P1")
            Rst1, cd2_brick, slot2, _ = build_structured_interp2(
                ml.levels[1].rels, tg1.tent_interp,
                tg1.interp_data.mis_numcoarsedof, geo, super_bricks,
                cd_brick, slot, bs)
            mid.update(Rst1=t(Rst1).to(rp_dtype), supers=super_bricks,
                       flat_id2=t(slot2 * int(np.prod(super_bricks))
                                  + cd2_brick))
        else:
            R1 = np.zeros((tg1.restr.shape[0], NB * bs))
            R1[:, flat_id] = tg1.restr.todense()
            mid["R1"] = dense(R1, rp_dtype)
    Ainv = _device_spd_inverse(np.asarray(tg1.Ac.todense(), np.float64),
                               device)
    with TIMERS.phase("compile.module"):
        h = StructuredHierarchy(
            dinv1=t(dinv1), taus1=inv_taus_f32(tg1.poly_data.roots),
            Ainv=Ainv.to(ainv_dtype), **fine, **mid)
        return h.to(device)


# ---------------------------------------------------------------------------
# solves


def struct_vcycle_apply(h: StructuredHierarchy, b: torch.Tensor,
                        graph: bool = True):
    """One V-cycle; on the card a replay of the hierarchy's captured
    V-cycle graph unless ``graph=False`` (solve/device_pcg.py)."""
    return graphed(h, h.vcycle, b.to(torch.float32), graph)


def struct_pcg_solve(h: StructuredHierarchy, b: torch.Tensor,
                     rel_tol: float = 1e-6, abs_tol: float = 0.0,
                     max_iter: int = 200, graph: bool = True):
    """PCG (solve/device_pcg.py) preconditioned by one V-cycle, with the
    f32 PCG operator; returns (x, iterations, final (B r, r)).  On the
    card the prologue and each iteration replay captured CUDA graphs
    unless ``graph=False`` asks for the eager loop."""
    return pcg(h, h.matvec0, h.vcycle, b.to(torch.float32), rel_tol=rel_tol,
               abs_tol=abs_tol, max_iter=max_iter, graph=graph)
