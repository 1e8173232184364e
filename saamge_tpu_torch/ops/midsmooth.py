"""Mid-level smoothing chains on the brick-block operator.

The operator lives in the slot-major padded layout (coarse dof (brick p,
slot s) at ``s * NB + p``) as ``blocks[k, s1, s2, p] = A1[(p, s1),
(p + doffs[k], s2)]`` over <= 27 brick offsets, with per-offset used-slot
rectangles ``rects[k] = (r1, r2)`` outside which a block is zero.

``brick_block_matvec`` is the plain matvec (the port of
BrickBlockOp.matvec).  ``mid_chain`` runs k roots
``x <- x + d (b - A1 x) * inv_tau_r`` and optionally the trailing
residual: for CUDA tensors as one launch of the cooperative kernel of
csrc/midsmooth.cu (replacing saamge_tpu/ops/pallas_midsmooth.py
`_build_mid_chain`), which keeps the operator resident in shared memory,
for CPU tensors as the chain of plain matvecs on the full blocks.  Both
widen bf16 blocks to f32 and multiply in f32.

The kernel reads the rectangles in a tile-major packing (``pack_tiles``,
built once from the same values as the full blocks): tiles of T
consecutive bricks, one per block of the launch, each a contiguous range
holding every (k, s1 < r1_k, s2 < r2_k) row's T values.
``mid_tile_plan`` picks T and the launch from the card's SM count and
shared-memory limit so that the tiles are one resident wave, and raises
``MidTileMisfit`` (never shrinks) when a tile does not fit."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.utils.logging import TIMERS

MAX_OFFSETS = 27        # SAAMGE_MAX_BOFFS of csrc/common.cuh
MAX_TILE = 64           # MID_MAX_TILE of csrc/midsmooth.cu: bricks a tile
WARPS = 16              # MID_WARPS: warps of a block
MAX_BS = 32             # slots a lane can sum in registers
ALIGN = 8               # a tile's values start on 16 bytes (8 bf16)
STATIC_SMEM = 512       # the kernel's static shared tables, reserved


class MidTileMisfit(ValueError):
    """The resident chain's tile does not fit a block's shared memory."""


class MidTilePlan(NamedTuple):
    """Launch of csrc/midsmooth.cu: block j holds bricks [j tile, (j + 1)
    tile) of the NB, ``stride`` values of the tile-major buffer; a warp
    takes ``tasks`` tasks of ``rows`` rectangle rows each, a lane one row
    and one brick pair."""
    tile: int
    stride: int
    rows: int
    tasks: int
    tiles: int
    threads: int
    smem: int

    def ints(self):
        return tuple(self)


def tile_stride(rects, tile: int) -> int:
    """Values of one tile: every rectangle row's ``tile`` values, rounded
    up to 16 bytes."""
    rows = sum(r1 * r2 for r1, r2 in rects)
    return -(-rows * tile // ALIGN) * ALIGN


def tile_plan(bricks, bs: int, rects, tile: int, itemsize: int,
              smem_per_block: int = _build.SMEM_MAX) -> MidTilePlan:
    """The launch for tiles of ``tile`` bricks (even, <= MAX_TILE);
    raises MidTileMisfit when bs exceeds MAX_BS or its shared bytes
    exceed ``smem_per_block``."""
    NB = int(bricks[0] * bricks[1] * bricks[2])
    if tile < 2 or tile % 2 or tile > MAX_TILE:
        raise ValueError(f"tile {tile}: expected an even 2..{MAX_TILE}")
    if not 1 <= bs <= MAX_BS:
        raise MidTileMisfit(f"bs {bs}: a lane sums at most {MAX_BS} slots")
    rows = 32 // (tile // 2)
    tasks = sum(-(-r2 // rows) for r1, r2 in rects if r1 > 0)
    stride = tile_stride(rects, tile)
    xrows = sum(r2 for _, r2 in rects)
    maxbs = 8 * -(-int(bs) // 8)
    smem = (stride * itemsize + 16 * tasks + 8 * xrows * tile
            + 4 * WARPS * (tile // 2) * maxbs * 2 + 12 * bs * tile)
    if smem + STATIC_SMEM > smem_per_block:
        raise MidTileMisfit(
            f"a tile of {tile} bricks needs {smem} shared bytes ({stride} "
            f"values of {itemsize} B, bs {bs}, {len(rects)} offsets) + "
            f"{STATIC_SMEM} static, over the {smem_per_block} a block may "
            "use")
    return MidTilePlan(tile, stride, rows, tasks, -(-NB // tile), 32 * WARPS,
                       smem)


def mid_tile_plan(bricks, bs: int, rects, sms: int, smem_per_block: int,
                  itemsize: int) -> MidTilePlan:
    """The resident chain's plan on a card of ``sms`` SMs: tiles of the
    fewest bricks (even, for the kernel's brick pairs) such that the tiles
    number at most ``sms`` (one block an SM, one resident wave).  Raises
    MidTileMisfit when such a tile exceeds ``smem_per_block``: it does
    not shrink the tile into a second wave."""
    NB = int(bricks[0] * bricks[1] * bricks[2])
    tile = 2 * -(-NB // (2 * int(sms)))
    if tile > MAX_TILE:
        raise MidTileMisfit(f"{NB} bricks on {sms} SMs need tiles of "
                            f"{tile} > {MAX_TILE} bricks")
    return tile_plan(bricks, bs, rects, tile, itemsize, smem_per_block)


def card_limits(device) -> tuple:
    """(SMs, shared bytes a block may use) of ``device``'s card; for a CPU
    device those of the H100 the port is built for."""
    device = torch.device(device)
    if device.type != "cuda":
        return _build.H100_SMS, _build.SMEM_MAX
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", _build.SMEM_MAX))


def pack_tiles(blocks: torch.Tensor, rects, tile: int) -> torch.Tensor:
    """Full (k, bs, bs, NB) blocks -> the flat tile-major buffer (same
    dtype and device, values copied exactly): tile j, row (k, s1 < r1_k,
    s2 < r2_k) in packed order, brick t at ``j * stride + row * tile +
    t``; zeros past NB and in each tile's alignment pad."""
    NB = blocks.shape[3]
    tiles = -(-NB // tile)
    rows = torch.cat([blocks[k, :r1, :r2, :].reshape(r1 * r2, NB)
                      for k, (r1, r2) in enumerate(rects)])
    rows = F.pad(rows, (0, tiles * tile - NB))
    per = rows.view(-1, tiles, tile).permute(1, 0, 2).reshape(tiles, -1)
    return F.pad(per, (0, tile_stride(rects, tile) - per.shape[1])) \
        .reshape(-1).contiguous()


def brick_block_matvec(blocks, doffs, bricks, x) -> torch.Tensor:
    """y = A1 x on slot-major flat (bs * NB,) vectors (plain torch)."""
    BX, BY, BZ = bricks
    bs, NB = blocks.shape[1], blocks.shape[3]
    xp = F.pad(x.to(torch.float32).view(bs, BX, BY, BZ), (1, 1, 1, 1, 1, 1))
    y = torch.zeros(bs, NB, dtype=torch.float32, device=x.device)
    for k, (dx, dy, dz) in enumerate(doffs):
        view = xp[:, 1 + dx:1 + dx + BX, 1 + dy:1 + dy + BY,
                  1 + dz:1 + dz + BZ].reshape(bs, NB)
        y += (blocks[k].to(torch.float32) * view[None]).sum(1)
    return y.reshape(-1)


def mid_chain_plain(blocks, doffs, bricks, inv_taus, b, d, x,
                    emit_res: bool = False):
    for it in inv_taus:
        x = x + d * (b - brick_block_matvec(blocks, doffs, bricks, x)) * it
    if emit_res:
        return x, b - brick_block_matvec(blocks, doffs, bricks, x)
    return x


@functools.lru_cache(maxsize=32)
def _launch_args(doffs, rects, bricks, bs: int, plan: MidTilePlan):
    """(ctypes geometry, ctypes plan) of one operator, checked once:
    BX, BY, BZ, bs, then per offset (dx, dy, dz, r1, r2).  The launcher
    checks the plan against the geometry and the tiles' dtype."""
    kd = len(doffs)
    if not 1 <= kd <= MAX_OFFSETS or len(rects) != kd:
        raise ValueError(f"{kd} block offsets, {len(rects)} rects")
    if any(not (0 <= r <= bs) for rect in rects for r in rect):
        raise ValueError(f"rects {rects} exceed bs={bs}")
    geom = list(bricks) + [bs]
    for (dx, dy, dz), (r1, r2) in zip(doffs, rects):
        geom += [dx, dy, dz, r1, r2]
    return _build.int_array(geom), _build.int_array(plan.ints())


def mid_chain(blocks, tiles, plan: MidTilePlan, doffs, rects, bricks,
              inv_taus, b, d, x, emit_res: bool = False):
    """All roots of one mid smoothing chain on flat (bs * NB,) vectors;
    returns x' or (x', b - A1 x').  CPU tensors: the plain chain on the
    full ``blocks``; CUDA tensors: one launch of the resident kernel on
    ``tiles`` (``pack_tiles(blocks, rects, plan.tile)``) by ``plan``
    (``mid_tile_plan`` or ``tile_plan`` for the tiles' dtype).
    ``doffs``, ``rects`` and ``bricks`` are tuples (the launch memo's
    key)."""
    if not 1 <= len(inv_taus) <= _build.MAX_ROOTS:
        raise ValueError(f"{len(inv_taus)} roots: expected "
                         f"1..{_build.MAX_ROOTS}")
    if not is_cuda(blocks, tiles, b, d, x):
        return mid_chain_plain(blocks, doffs, bricks, inv_taus, b, d, x,
                               emit_res)
    kd, bs, _, NB = blocks.shape
    if bricks[0] * bricks[1] * bricks[2] != NB:
        raise ValueError(f"bricks {bricks} do not match NB={NB}")
    geom, plan_c = _launch_args(tuple(doffs), tuple(rects), tuple(bricks),
                                bs, MidTilePlan(*plan))
    check(tiles, "tiles", (torch.float32, torch.bfloat16),
          (plan.tiles * plan.stride,))
    for name, v in (("b", b), ("d", d), ("x", x)):
        check(v, name, torch.float32, (bs * NB,))
    taus = _build.float_array(inv_taus)
    lib = _build.load()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    res = torch.empty_like(x) if emit_res else None
    with torch.cuda.device(x.device):
        code = lib.saamge_mid_chain(
            tiles.data_ptr(), int(tiles.dtype == torch.bfloat16),
            ctypes.addressof(geom), kd, ctypes.addressof(plan_c),
            ctypes.addressof(taus), len(inv_taus), int(emit_res),
            b.data_ptr(), d.data_ptr(), x.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), res.data_ptr() if res is not None else None,
            _build.stream_ptr(x.device))
    _build.check_launch(lib, code, f"mid_chain ({plan.tiles} tiles of "
                        f"{plan.tile} bricks, {plan.threads} threads, "
                        f"{plan.smem} shared bytes)")
    TIMERS.count("midsmooth.kernel")
    return (out, res) if emit_res else out
