"""Port mid-level chain (saamge_tpu_torch/ops/midsmooth.py) against the
JAX resident Pallas chain (pallas_midsmooth.mid_chain, interpret mode,
symmetry-halved packing as in the flagship) on the flagship n=16 mid
operator, and the plain brick-block matvec against the host CSR; the
kernel's tile-major packing and its launch plan."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops.pallas_midsmooth import (mid_chain as jax_mid_chain,
                                             pad_vec, prep_blocksT,
                                             unpad_vec)
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import compile_structured, flagship_problem
from saamge_tpu_torch.ops.midsmooth import (MidTileMisfit,
                                            brick_block_matvec, mid_chain,
                                            mid_tile_plan, pack_tiles,
                                            tile_plan)

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def mid():
    ml, _, geo, supers = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    h = compile_structured(ml, geo, supers, mid_dtype=torch.float32,
                           device="cpu")
    tg0 = ml.levels[0].tg_data
    cd_brick, slot, bs, _ = JS.coarse_brick_numbering(
        ml.levels[0].rels, tg0.interp_data.mis_numcoarsedof)
    jops = {name: JS.BrickBlockOp.from_csr(tg0.Ac.tocsr(), cd_brick, slot,
                                           bs, geo.bricks, dtype=jdt)
            for name, (_, jdt) in DTYPES.items()}
    rng = np.random.default_rng(3)
    v = {k: rng.standard_normal(h.n_flat).astype(np.float32)
         for k in ("b", "x")}
    return ml, h, jops, v


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mid_chain_matches_pallas(mid, dtype, emit_res):
    """f32 blocks at 1e-5 relative; bf16 blocks at 1e-2 (the JAX kernel
    multiplies in bf16, the port widens to f32)."""
    _, h, jops, v = mid
    op = jops[dtype]
    NB = h.geo.num_bricks
    assert op.doffs == h.doffs and op.rects == h.rects
    d = h.dinv1.numpy()
    jt = tuple(jnp.asarray([t], jnp.float32) for t in h.taus1)
    ref = jax_mid_chain(prep_blocksT(op, sym=True), op.doffs, op.rects,
                        op.bricks, h.bs, NB, jt,
                        *(pad_vec(jnp.asarray(a), h.bs, NB)
                          for a in (v["b"], d, v["x"])),
                        emit_res=emit_res, interpret=True, sym=True)
    blocks = h.A1_blocks.to(DTYPES[dtype][0])
    tiles = pack_tiles(blocks, h.rects, h.mid_plan.tile)
    got = mid_chain(blocks, tiles, h.mid_plan, h.doffs, h.rects,
                    h.geo.bricks, h.taus1,
                    torch.as_tensor(v["b"]), h.dinv1,
                    torch.as_tensor(v["x"]), emit_res=emit_res)
    if not emit_res:
        ref, got = (ref,), (got,)
    tol = 1e-5 if dtype == "f32" else 1e-2
    for r, g in zip(ref, got):
        r = np.asarray(unpad_vec(r, h.bs, NB))
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max()


def test_brick_block_matvec_matches_csr(mid):
    ml, h, _, v = mid
    Ac = ml.levels[0].tg_data.Ac.tocsr()
    fid = h.flat_id.numpy()
    x = np.zeros(h.n_flat, np.float32)
    x[fid] = v["x"][:len(fid)]
    y = brick_block_matvec(h.A1_blocks, h.doffs, h.geo.bricks,
                           torch.as_tensor(x)).numpy()
    y_ref = Ac @ x[fid].astype(np.float64)
    assert np.abs(y[fid] - y_ref).max() <= 1e-5 * np.abs(y_ref).max()
    pad = np.ones(h.n_flat, bool)
    pad[fid] = False
    assert np.all(y[pad] == 0)


def test_flagship_hierarchy_takes_resident_route(mid):
    _, h, _, _ = mid
    assert h.mid_route == "resident" and h.A1_packed is None
    assert torch.equal(h.A1_tiles, pack_tiles(h.A1_blocks, h.rects,
                                              h.mid_plan.tile))


def unpack_tiles(tiles: torch.Tensor, rects, bs: int, NB: int,
                 tile: int) -> torch.Tensor:
    """Inverse of ``pack_tiles``: the (k, bs, bs, NB) blocks, zero outside
    the rectangles."""
    n_tiles = -(-NB // tile)
    rows = sum(r1 * r2 for r1, r2 in rects)
    per = tiles.view(n_tiles, -1)[:, :rows * tile]
    flat = per.view(n_tiles, rows, tile).permute(1, 0, 2) \
        .reshape(rows, n_tiles * tile)[:, :NB]
    out = torch.zeros(len(rects), bs, bs, NB, dtype=tiles.dtype,
                      device=tiles.device)
    at = 0
    for k, (r1, r2) in enumerate(rects):
        out[k, :r1, :r2] = flat[at:at + r1 * r2].view(r1, r2, NB)
        at += r1 * r2
    return out



def _ragged_blocks(bricks, bs, rects, seed, dtype):
    """Random (k, bs, bs, NB) blocks, zero outside the rectangles."""
    NB = bricks[0] * bricks[1] * bricks[2]
    rng = np.random.default_rng(seed)
    blocks = torch.zeros(len(rects), bs, bs, NB)
    for k, (r1, r2) in enumerate(rects):
        blocks[k, :r1, :r2] = torch.as_tensor(
            rng.standard_normal((r1, r2, NB)), dtype=torch.float32)
    return blocks.to(dtype)


RAGGED_RECTS = ((0, 5), (13, 13), (3, 13), (7, 2), (1, 1), (13, 0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [2, 4, 8, 14])
def test_tiles_unpack_to_blocks_exactly(tile, dtype):
    """Every rectangle's values survive the tile-major packing exactly,
    for tiles that divide NB and ragged last tiles (NB = 105)."""
    bricks, bs = (5, 3, 7), 13
    blocks = _ragged_blocks(bricks, bs, RAGGED_RECTS, tile, DTYPES[dtype][0])
    NB = blocks.shape[3]
    tiles = pack_tiles(blocks, RAGGED_RECTS, tile)
    plan = tile_plan(bricks, bs, RAGGED_RECTS, tile, blocks.element_size())
    assert tiles.numel() == plan.tiles * plan.stride
    assert plan.stride * blocks.element_size() % 16 == 0
    assert torch.equal(unpack_tiles(tiles, RAGGED_RECTS, bs, NB, tile),
                       blocks)
    # tile j's row (k, s1, s2) holds bricks j * tile .. in one range
    k, (r1, r2) = 2, RAGGED_RECTS[2]
    row = sum(a * b for a, b in RAGGED_RECTS[:k]) + 1 * r2 + 4
    j = NB // tile
    got = tiles[j * plan.stride + row * tile:
                j * plan.stride + (row + 1) * tile]
    want = torch.zeros(tile, dtype=blocks.dtype)
    want[:NB - j * tile] = blocks[k, 1, 4, j * tile:]
    assert torch.equal(got, want)


def test_tiles_of_flagship_blocks_unpack_exactly(mid):
    _, h, _, _ = mid
    NB = h.geo.num_bricks
    for tile in (2, 6, h.mid_plan.tile):
        t = pack_tiles(h.A1_blocks, h.rects, tile)
        assert torch.equal(unpack_tiles(t, h.rects, h.bs, NB, tile),
                           h.A1_blocks)


def test_mid_tile_plan_is_one_wave():
    """n=96 flagship shapes (12^3 bricks, bs 20, ~4,570 rectangle rows)
    on 132 SMs: tiles of 14 bricks, 124 blocks, within a block's shared
    memory."""
    rects = ((13, 13),) * 27
    plan = mid_tile_plan((12, 12, 12), 20, rects, 132, 232448, 2)
    assert plan.tile == 14 and plan.tiles == 124 <= 132
    assert plan.threads == 512 and plan.rows == 4
    assert plan.smem <= 232448


@pytest.mark.parametrize("smem", [1000, 50000])
def test_mid_tile_plan_raises_rather_than_shrinks(smem):
    rects = ((13, 13),) * 27
    with pytest.raises(MidTileMisfit, match="shared bytes"):
        mid_tile_plan((12, 12, 12), 20, rects, 132, smem, 2)
    # the same operator in f32 does not fit a block of an H100
    with pytest.raises(MidTileMisfit):
        mid_tile_plan((12, 12, 12), 20, rects, 132, 232448, 4)


def test_compile_takes_packed_route_when_tiles_misfit(mid, monkeypatch):
    """A card whose block cannot hold a tile gets the packed passes: the
    same chain on the same values."""
    import saamge_tpu_torch.solve.structured as S
    ml, h, _, v = mid
    monkeypatch.setattr(S, "card_limits", lambda device: (132, 1024))
    hp = S.compile_structured(ml, h.geo, h.supers, mid_dtype=torch.float32,
                              device="cpu")
    assert hp.mid_route == "packed" and hp.A1_tiles is None
    assert torch.equal(hp.A1_blocks, h.A1_blocks)
    rc = torch.as_tensor(v["b"])
    got, ref = hp.mid_correct(rc), h.mid_correct(rc)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
