"""Matrix-free Q1 fine operator: the 27 stencil values of every row are
recomputed from the element coefficient field instead of being stored.

On a uniform hex mesh the element matrices factor as ``em_e = c_e * K``
(fem/assemble.py diffusion_factorized), so every DIA value is a sum of
at most 8 weighted neighbouring coefficients:

    A[u, u + delta] = sum_{(l, l'): corner(l') - corner(l) = delta}
                          K[l, l'] * c(u - corner(l))

with c stored at each element's lowest corner node.  Essential-BC
elimination (keep_diag, fem/assemble.py eliminate_essential_bc) comes
from the node mask m (1 = free, 0 = essential):

    y = m * A_full(m * x) + (1 - m) * d * x,   d = the delta = 0 value.

The c field is zero on the last node plane of each dimension and in the
halo, so every tap that wraps to the next grid line or leaves the grid
reads a zero coefficient: no per-tap bounds test is needed.

Layout: the flat haloed vectors of ops/sparse.DIA, with the same
``halo = max|offset| = sx + sy + 1`` (sx = NYn*NZn, sy = NZn), so the
passes chain with the stored-DIA ones and with each other.  The TPU
kernel's (rows, 128) tiling, its lane-shift groups and its z-lane
(``nzp``) variant are lane artefacts of that layout and are not ported.

``mfree_h`` launches the hand-written kernel (csrc/mfree.cu, replacing
saamge_tpu/ops/pallas_mfree.py `_build_mfree`) for CUDA tensors and runs
``mfree_plain_h`` for CPU tensors.  ``mfree_chain`` runs all roots of a
smoothing chain and the trailing residual in one cooperative launch of
the same kernel's body (the JAX package runs them as one pass each,
saamge_tpu/solve/structured.py `_smooth_h`; ``mfree_chain_plain`` is that
loop).  Arithmetic is f32; bf16 c and m are widened on load.

The kernel takes one of two routes, which ``mfree_plan`` picks from the
dims, and counts it (``mfree.route.tiled`` / ``mfree.route.flat``).
Tiled, where a level's working set exceeds the L2: a block owns a 2D
(y, z) tile of the node plane and marches along x over a chunk of
planes, all tiles of a chunk side by side; a thread holds two nodes
along z, each plane adds its taps to the three outputs it reaches, and
a thread carries its tap sums and its c of the plane behind in
registers, so that only the newest plane goes through shared memory.
Its windows do not grow with NZn.  It is bound by the bytes from device
memory: at n=192 (193^3 nodes, ~145 MB a level with the bf16 chain) ~48
us a level, of which it takes ~90.  Flat, where the working set fits the
L2 and NZn <= 127: a block owns 512 consecutive nodes of the flat (y, z)
index and computes each plane whole from a shared ring of four x*m and
three c planes.  There a level is bound by issue (n=96: ~22 MB, ~8-11 us
a level), and an item of a few planes takes two steps fewer than on the
tiled route.  TMA is not used: a haloed vector's y stride (NZn values,
772 B in f32 at NZn = 193) is not a multiple of 16 B, as a tensor map
needs.

``mfree_point_h`` launches the first design (one thread a node), the
reference the card's check holds both routes' passes to, bit for bit.
The counters ``mfree.kernel`` (a launch of csrc/mfree.cu: pass, chain or
the one-thread-a-node reference) and ``mfree.plain`` (a call on the
plain route) of utils/logging.TIMERS count each call;
``mfree.kernel.<mode>`` counts the passes of ``mfree_h`` by mode and
``mfree.kernel.chain`` the chains."""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.stencil import MODES
from saamge_tpu_torch.utils.logging import TIMERS

# MFEM hex corner ordering (fem/mesh.py hex_mesh): bottom face CCW, then
# the top face; the same bit rule is written out in csrc/mfree.cu.
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def q1_halo(dims) -> int:
    """max|offset| of the Q1 stencil on a (NXn, NYn, NZn) node grid."""
    return dims[1] * dims[2] + dims[2] + 1


@dataclasses.dataclass
class MatrixFreeQ1:
    c_h: torch.Tensor           # haloed (n + 2 halo,) coefficient field
    m_h: torch.Tensor           # haloed free-dof mask, same dtype as c_h
    K: Tuple[Tuple[float, ...], ...]    # (8, 8) reference element matrix
    dims: Tuple[int, int, int]  # nodes (NXn, NYn, NZn)

    @property
    def n(self) -> int:
        NXn, NYn, NZn = self.dims
        return NXn * NYn * NZn

    @property
    def strides(self) -> Tuple[int, int]:
        return self.dims[1] * self.dims[2], self.dims[2]

    @property
    def halo(self) -> int:
        return q1_halo(self.dims)

    @staticmethod
    def build(c_elem, ess_dofs, em0, dims, cdtype=torch.bfloat16,
              A_csr=None) -> "MatrixFreeQ1":
        """``c_elem``: per-element coefficients in the mesh's
        lexicographic element order; ``ess_dofs``: essential node ids;
        ``em0``: the (8, 8) reference element matrix.  With ``A_csr``
        the assembled operator's diagonal is checked against the (c, K)
        reconstruction on every row; a mismatch raises ValueError."""
        NXn, NYn, NZn = (int(v) for v in dims)
        nx, ny, nz = NXn - 1, NYn - 1, NZn - 1
        c3 = np.asarray(c_elem, np.float64).reshape(nx, ny, nz)
        cg = np.zeros((NXn, NYn, NZn))
        cg[:nx, :ny, :nz] = c3
        m = np.ones(NXn * NYn * NZn)
        m[np.asarray(ess_dofs, np.int64)] = 0.0
        K = np.asarray(em0, np.float64)
        if A_csr is not None:
            d = np.zeros((NXn, NYn, NZn))
            for l, (ax, ay, az) in enumerate(CORNERS):
                d[ax:ax + nx, ay:ay + ny, az:az + nz] += K[l, l] * c3
            if not np.allclose(d.ravel(), np.asarray(A_csr.diagonal()),
                               rtol=1e-8, atol=0.0):
                raise ValueError(
                    "(em0, c) factorization does not reproduce the "
                    "operator diagonal: the matrix-free fine level is "
                    "invalid for this problem")
        h = q1_halo(dims)

        def haloed(flat):
            # rounded to f32 first, as the JAX package's arrays are
            out = torch.zeros(flat.size + 2 * h, dtype=torch.float32)
            out[h:h + flat.size] = torch.as_tensor(flat)
            return out.to(cdtype)

        return MatrixFreeQ1(haloed(cg.ravel()), haloed(m),
                            tuple(tuple(float(v) for v in row) for row in K),
                            (NXn, NYn, NZn))

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """flat (n,) -> haloed (n + 2 halo,) f32."""
        return torch.nn.functional.pad(x.to(torch.float32),
                                       (self.halo, self.halo))

    def unpad(self, xh: torch.Tensor) -> torch.Tensor:
        return xh[self.halo:self.halo + self.n]


def _delta_values(op: MatrixFreeQ1, c: torch.Tensor):
    """{(dx, dy, dz): A values on the n interior rows}: the 27 stencil
    values rebuilt from the 8 corner-shifted slices of c."""
    sx, sy = op.strides
    h, n = op.halo, op.n
    cl = []
    for ax, ay, az in CORNERS:
        s = ax * sx + ay * sy + az
        cl.append(c[h - s:h - s + n])
    vals = {}
    for l, (ax, ay, az) in enumerate(CORNERS):
        for lp, (bx, by, bz) in enumerate(CORNERS):
            key = (bx - ax, by - ay, bz - az)
            term = op.K[l][lp] * cl[l]
            vals[key] = term if key not in vals else vals[key] + term
    return vals


def mfree_plain_h(mode: str, op: MatrixFreeQ1, xh, bh=None, dinvh=None,
                  inv_tau: float = 0.0) -> torch.Tensor:
    if mode not in MODES:
        raise ValueError(mode)
    sx, sy = op.strides
    h, n = op.halo, op.n
    m = op.m_h.to(torch.float32)
    vals = _delta_values(op, op.c_h.to(torch.float32))
    xm = xh * m
    acc = torch.zeros(n, dtype=torch.float32, device=xh.device)
    for (dx, dy, dz), v in sorted(vals.items()):
        off = dx * sx + dy * sy + dz
        acc += v * xm[h + off:h + off + n]
    mc, xc = m[h:h + n], xh[h:h + n]
    y = mc * acc + (1.0 - mc) * (vals[(0, 0, 0)] * xc)
    if mode == "residual":
        y = bh[h:h + n] - y
    elif mode == "root":
        y = xc + dinvh[h:h + n] * (bh[h:h + n] - y) * inv_tau
    return op.pad(y)


THREADS = 256           # MFREE_THREADS of csrc/mfree.cu
RUN = 2                 # MFREE_RUN: tiled nodes a thread holds, along z
FLAT = 512              # MFREE_FLAT: nodes of a flat range (two a thread)
WINDOW = 3              # MFREE_WIN: window positions a thread fetches a plane
MIN_BLOCKS = 3          # MFREE_MIN_BLOCKS: resident blocks an SM
ROUTES = ("tiled", "flat")
H100_L2 = 50 * 2 ** 20  # L2 bytes of an H100 SXM
# bytes a haloed node holds in the L2 test: x, out, tmp, res, b, dinv in
# f32 and c, m (f32 at most)
NODE_BYTES = 8 * 4


class MfreePlan(NamedTuple):
    """Launch of csrc/mfree.cu on ``route`` ("tiled" or "flat"): (y, z)
    tiles of ``ty`` x ``tz`` nodes, ``ky`` x ``kz`` of them (the last of
    each row or column ragged; flat: ranges of ``tz`` = FLAT consecutive
    flat (y, z) positions, ``ty`` = 0, ``ky`` = 1); ``blocks`` blocks (the
    chain runs as many as fit the card at once, up to these), over which
    the kernel cuts the planes into as many chunks as leave one item (a
    tile over a chunk) a block; ``smem`` bytes hold the ring (tiled: two
    slots each of the (ty + 2) x (tz + 2) x*m and c windows, rows of pitch
    tz + 3; flat: four x*m and three c windows of a range)."""
    route: str
    ty: int
    tz: int
    ky: int
    kz: int
    blocks: int
    smem: int

    def ints(self):
        return (ROUTES.index(self.route),) + tuple(self[1:])

    @property
    def tiles(self) -> int:
        return self.ky * self.kz

    @property
    def pitch(self) -> int:
        return self.tz + 3


def tile_shape(NYn: int, NZn: int):
    """(ty, tz, ky, kz): of the tile widths tz in [16, 64] that are
    multiples of RUN, each with the most rows whose tz / RUN threads a row
    and (ty + 2) x (tz + 2) window fit a block, then rows evened over the
    ky tiles, the one with the fewest node slots ky ty kz tz; ties to the
    wider tile."""
    best = None
    for tz in range(16, 65, RUN):
        ty = min(THREADS // (tz // RUN), WINDOW * THREADS // (tz + 2) - 2)
        ky, kz = -(-NYn // ty), -(-NZn // tz)
        ty = -(-NYn // ky)
        key = (ky * ty * kz * tz, -tz)
        if best is None or key < best[0]:
            best = (key, (ty, tz, ky, kz))
    return best[1]


def tiled_plan(dims, sms: int = _build.H100_SMS) -> MfreePlan:
    """The tiled route: the tile shape from the dims and one wave of
    MIN_BLOCKS blocks on each of ``sms`` SMs (no more blocks than tile x
    plane items)."""
    NXn, NYn, NZn = (int(v) for v in dims)
    ty, tz, ky, kz = tile_shape(NYn, NZn)
    blocks = min(MIN_BLOCKS * int(sms), ky * kz * NXn)
    smem = 4 * 4 * (ty + 2) * (tz + 3)
    _build.check_plan(THREADS, (blocks,), smem)
    return MfreePlan("tiled", ty, tz, ky, kz, blocks, smem)


def flat_plan(dims, sms: int = _build.H100_SMS) -> MfreePlan:
    """The flat route: ranges of FLAT flat (y, z) positions and one wave
    as in ``tiled_plan``; ValueError where a range's x*m window (FLAT +
    2 NZn + 2 values) exceeds WINDOW values a thread (NZn > 127)."""
    NXn, NYn, NZn = (int(v) for v in dims)
    if FLAT + 2 * NZn + 2 > WINDOW * THREADS:
        raise ValueError(f"NZn = {NZn}: the flat route's x*m window of "
                         f"{FLAT + 2 * NZn + 2} nodes exceeds "
                         f"{WINDOW} x {THREADS}")
    kz = -(-(NYn * NZn) // FLAT)
    blocks = min(MIN_BLOCKS * int(sms), kz * NXn)
    smem = 4 * (4 * (FLAT + 2 * NZn + 2) + 3 * (FLAT + NZn + 1))
    _build.check_plan(THREADS, (blocks,), smem)
    return MfreePlan("flat", 0, FLAT, 1, kz, blocks, smem)


def mfree_plan(dims, sms: int = _build.H100_SMS,
               l2_bytes: int = H100_L2) -> MfreePlan:
    """The flat route where a level's working set (NODE_BYTES a haloed
    node) fits the L2 and its window fits a block (NZn <= 127): there a
    level runs from L2, is bound by issue, and an item of a few planes
    takes two steps fewer on the flat route; the tiled route elsewhere."""
    NXn, NYn, NZn = (int(v) for v in dims)
    haloed = NXn * NYn * NZn + 2 * q1_halo((NXn, NYn, NZn))
    if (haloed * NODE_BYTES <= l2_bytes
            and FLAT + 2 * NZn + 2 <= WINDOW * THREADS):
        return flat_plan(dims, sms)
    return tiled_plan(dims, sms)


@functools.lru_cache(maxsize=8)
def _k_array(K):
    """K as the launcher's float[64], built once per matrix (the
    wrapper's host time is a large share of a pass at n=96)."""
    return _build.float_array([v for row in K for v in row])


@functools.lru_cache(maxsize=8)
def _plan(dims, device_index: int):
    """The card's plan and its launcher array, with the counter name of
    its route."""
    props = torch.cuda.get_device_properties(device_index)
    plan = mfree_plan(dims, props.multi_processor_count,
                      getattr(props, "L2_cache_size", H100_L2))
    return _build.int_array(plan.ints()), f"mfree.route.{plan.route}"


def _check_op(op: MatrixFreeQ1, vecs: dict) -> None:
    size = op.n + 2 * op.halo
    check(op.c_h, "c_h", (torch.float32, torch.bfloat16), (size,))
    check(op.m_h, "m_h", op.c_h.dtype, (size,))
    for name, v in vecs.items():
        check(v, name, torch.float32, (size,))


def _mode_vecs(mode: str, xh, bh, dinvh) -> dict:
    if mode not in MODES:
        raise ValueError(mode)
    vecs = {"x": xh}
    if mode in ("residual", "root"):
        vecs["b"] = bh
    if mode == "root":
        vecs["dinv"] = dinvh
    return vecs


def mfree_h(mode: str, op: MatrixFreeQ1, xh, bh=None, dinvh=None,
            inv_tau: float = 0.0) -> torch.Tensor:
    """One matrix-free pass in ``mode`` ('spmv', 'residual' or 'root')
    on haloed vectors; the output's halo is zero."""
    vecs = _mode_vecs(mode, xh, bh, dinvh)
    if not is_cuda(op.c_h, op.m_h, *vecs.values()):
        TIMERS.count("mfree.plain")
        return mfree_plain_h(mode, op, xh, bh, dinvh, inv_tau)
    _check_op(op, vecs)
    lib = _build.load()
    y = torch.empty_like(xh)
    K = _k_array(op.K)
    plan, route = _plan(tuple(op.dims), xh.device.index)
    with torch.cuda.device(xh.device):
        code = lib.saamge_mfree(
            MODES[mode], op.c_h.data_ptr(), op.m_h.data_ptr(),
            int(op.c_h.dtype == torch.bfloat16), ctypes.addressof(K),
            *op.dims, op.halo, ctypes.addressof(plan), xh.data_ptr(),
            vecs["b"].data_ptr() if "b" in vecs else None,
            vecs["dinv"].data_ptr() if "dinv" in vecs else None,
            float(inv_tau), y.data_ptr(), _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, "mfree")
    TIMERS.count("mfree.kernel")
    TIMERS.count(route)
    TIMERS.count("mfree.kernel." + mode)
    return y


def mfree_point_h(mode: str, op: MatrixFreeQ1, xh, bh=None, dinvh=None,
                  inv_tau: float = 0.0) -> torch.Tensor:
    """``mfree_h`` by the first design of its kernel, one thread a node
    with every value from device memory: the reference that the tiled
    pass must equal bit for bit on the card.  CPU tensors run the plain
    version."""
    vecs = _mode_vecs(mode, xh, bh, dinvh)
    if not is_cuda(op.c_h, op.m_h, *vecs.values()):
        TIMERS.count("mfree.plain")
        return mfree_plain_h(mode, op, xh, bh, dinvh, inv_tau)
    _check_op(op, vecs)
    lib = _build.load()
    y = torch.empty_like(xh)
    K = _k_array(op.K)
    with torch.cuda.device(xh.device):
        code = lib.saamge_mfree_point(
            MODES[mode], op.c_h.data_ptr(), op.m_h.data_ptr(),
            int(op.c_h.dtype == torch.bfloat16), ctypes.addressof(K),
            *op.dims, op.halo, xh.data_ptr(),
            vecs["b"].data_ptr() if "b" in vecs else None,
            vecs["dinv"].data_ptr() if "dinv" in vecs else None,
            float(inv_tau), y.data_ptr(), _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, "mfree_point")
    TIMERS.count("mfree.kernel")
    return y


def mfree_chain_plain(op: MatrixFreeQ1, inv_taus, bh, dinvh, xh,
                      emit_residual: bool = False):
    """The roots one plain pass each, then the residual pass (the JAX
    package's chain of root_h and residual_h)."""
    for it in inv_taus:
        xh = mfree_plain_h("root", op, xh, bh, dinvh, it)
    if emit_residual:
        return xh, mfree_plain_h("residual", op, xh, bh)
    return xh


def mfree_chain(op: MatrixFreeQ1, inv_taus, bh, dinvh, xh,
                emit_residual: bool = False):
    """Roots x <- x + dinv (b - A x) * inv_tau_r over haloed vectors, and
    with ``emit_residual`` the residual b - A x: one cooperative launch
    for CUDA tensors; returns xh' or (xh', resh)."""
    if not 1 <= len(inv_taus) <= _build.MAX_ROOTS:
        raise ValueError(f"{len(inv_taus)} roots: expected "
                         f"1..{_build.MAX_ROOTS}")
    vecs = {"x": xh, "b": bh, "dinv": dinvh}
    if not is_cuda(op.c_h, op.m_h, *vecs.values()):
        TIMERS.count("mfree.plain")
        return mfree_chain_plain(op, inv_taus, bh, dinvh, xh, emit_residual)
    _check_op(op, vecs)
    lib = _build.load()
    out = torch.empty_like(xh)
    tmp = torch.empty_like(xh)
    res = torch.empty_like(xh) if emit_residual else None
    K = _k_array(op.K)
    plan, route = _plan(tuple(op.dims), xh.device.index)
    taus = _build.float_array(inv_taus)
    with torch.cuda.device(xh.device):
        code = lib.saamge_mfree_chain(
            op.c_h.data_ptr(), op.m_h.data_ptr(),
            int(op.c_h.dtype == torch.bfloat16), ctypes.addressof(K),
            *op.dims, op.halo, ctypes.addressof(plan),
            ctypes.addressof(taus), len(inv_taus), int(emit_residual),
            bh.data_ptr(), dinvh.data_ptr(), xh.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), res.data_ptr() if res is not None else None,
            _build.stream_ptr(xh.device))
    _build.check_launch(lib, code, "mfree_chain")
    TIMERS.count("mfree.kernel")
    TIMERS.count(route)
    TIMERS.count("mfree.kernel.chain")
    return (out, res) if emit_residual else out
