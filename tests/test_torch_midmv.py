"""Port packed mid matvec (saamge_tpu_torch/ops/midmv.py) against the
JAX lane-chunked Pallas matvec (pallas_midmv.chunked_matvec, interpret
mode, host-packed blocks as in the capacity configuration) on the
flagship n=16 mid operator, whose used-slot rectangles are ragged, and
against the port's full-block matvec; its residual and root modes
against the JAX chain's expressions around that matvec; the kernel's
launch plan and memoised geometry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops.pallas_midmv import chunked_matvec, prep_blocks_chunked
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import flagship_problem
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops import midmv as M
from saamge_tpu_torch.ops.midmv import (midmv, midmv_plain, midmv_plan,
                                        pack_blocks, packed_starts)
from saamge_tpu_torch.ops.midsmooth import brick_block_matvec
from saamge_tpu_torch.solve.structured import (brick_block_from_csr,
                                               coarse_brick_numbering)

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def mid():
    ml, _, geo, _ = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    tg0 = ml.levels[0].tg_data
    cd_brick, slot, bs, _ = coarse_brick_numbering(
        ml.levels[0].rels, tg0.interp_data.mis_numcoarsedof)
    Ac = tg0.Ac.tocsr()
    blocks, doffs, rects = brick_block_from_csr(Ac, cd_brick, slot, bs,
                                                geo.bricks)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(bs * geo.num_bricks).astype(np.float32)
    return dict(Ac=Ac, cd_brick=cd_brick, slot=slot, bs=bs, geo=geo,
                blocks=blocks, doffs=doffs, rects=rects, x=x)


@pytest.fixture(scope="module")
def jax_ax(mid):
    """A x of the JAX chunked Pallas matvec (interpret mode), per block
    dtype, computed once."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jdt = DTYPES[dtype][1]
            geo, bs = mid["geo"], mid["bs"]
            hb = []
            op = JS.BrickBlockOp.from_csr(mid["Ac"], mid["cd_brick"],
                                          mid["slot"], bs, geo.bricks, jdt,
                                          host_blocks_out=hb)
            assert op.doffs == mid["doffs"] and op.rects == mid["rects"]
            jblocks, Lc = prep_blocks_chunked(op, host_blocks=hb[0])
            cache[dtype] = chunked_matvec(jblocks, op.doffs, op.rects,
                                          geo.bricks, bs, geo.num_bricks,
                                          Lc, jnp.asarray(mid["x"]),
                                          interpret=True)
        return cache[dtype]
    return get


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_midmv_modes_match_jax(mid, jax_ax, mode, dtype):
    """Each mode against the JAX capacity chain's expression around
    chunked_matvec (saamge_tpu/solve/structured.py mid_correct: the root
    x1 + dinv1 * (b1 - A x1) * it, the residual b1 - A x1), with the
    mid smoother's dinv (0 on padding slots); f32 blocks at 1e-5
    relative, bf16 at 1e-2 (the JAX kernel rounds x and each product to
    bf16, the port multiplies in f32)."""
    tdt = DTYPES[dtype][0]
    geo, bs = mid["geo"], mid["bs"]
    n = bs * geo.num_bricks
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n).astype(np.float32)
    dinv = np.zeros(n, np.float32)
    fid = mid["slot"] * geo.num_bricks + mid["cd_brick"]
    dinv[fid] = 1.0 / mid["Ac"].diagonal()
    inv_tau = np.float32(0.7)
    ax, x = jax_ax(dtype), jnp.asarray(mid["x"])
    ref = {"spmv": ax, "residual": jnp.asarray(b) - ax,
           "root": x + jnp.asarray(dinv) * (jnp.asarray(b) - ax)
           * inv_tau}[mode]
    ref = np.asarray(ref)
    packed = pack_blocks(mid["blocks"], mid["rects"], tdt)
    got = midmv(packed, mid["doffs"], mid["rects"], geo.bricks, bs,
                torch.as_tensor(mid["x"]), mode, torch.as_tensor(b),
                torch.as_tensor(dinv), float(inv_tau)).numpy()
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# the n=96 capacity operator, ragged grids (no side a multiple of the
# tile), and the n=16 one of the fixture
PLAN_SHAPES = [((12, 12, 12), 20), ((5, 3, 7), 13), ((6, 5, 4), 13),
               ((4, 4, 4), 9)]


@pytest.mark.parametrize("bricks,bs", PLAN_SHAPES)
def test_midmv_plan_covers_every_output_once(bricks, bs):
    NB = int(np.prod(bricks))
    # 27 offsets, ragged rectangles with r1 = 0, r2 = bs and (bs, bs)
    rng = np.random.default_rng(3)
    rects = ((0, 5), (bs, bs), (3, bs)) + tuple(
        (int(a), int(b)) for a, b in rng.integers(0, bs + 1, (24, 2)))
    plan = midmv_plan(bricks, bs, rects)
    tasks = sum(-(-r2 // M.TASK) for _, r2 in rects)
    assert plan.threads == 32 * M.WARPS <= 1024
    assert plan.smem == 4 * (tasks + M.WARPS * M.SLOTS * M.TILE)
    assert plan.smem <= _build.SMEM_MAX
    assert plan.grid[0] * M.TILE >= NB and plan.grid[1] * M.SLOTS >= bs
    assert plan.grid[1] <= 65535
    got = np.concatenate([plan.block_outputs(NB, bs, tx, g)
                          for tx in range(plan.grid[0])
                          for g in range(plan.grid[1])])
    assert len(got) == bs * NB
    np.testing.assert_array_equal(np.sort(got), np.arange(bs * NB))


def test_midmv_geometry_is_memoised(mid):
    geo, bs = mid["geo"], mid["bs"]
    key = (mid["doffs"], mid["rects"], geo.bricks, bs)
    got = M._launch_args(*key)
    assert M._launch_args(*key) is got
    fresh = M._launch_args.__wrapped__(*key)
    for a, b in zip(got[:2], fresh[:2]):
        assert list(a) == list(b)
    assert got[2] == fresh[2] == packed_starts(mid["rects"],
                                               geo.num_bricks)[1]
    geom = list(got[0])
    assert geom[:4] == [*geo.bricks, bs]
    assert geom[4:] == [v for d, r in zip(mid["doffs"], mid["rects"])
                        for v in (*d, *r)]
    assert list(got[1]) == list(midmv_plan(geo.bricks, bs,
                                           mid["rects"]).ints())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_midmv_matches_pallas(mid, jax_ax, dtype):
    """f32 blocks at 1e-5 relative; bf16 blocks at 1e-2 (the JAX kernel
    rounds x and each product to bf16, the port multiplies in f32)."""
    tdt = DTYPES[dtype][0]
    geo, bs, rects = mid["geo"], mid["bs"], mid["rects"]
    assert len(set(rects)) > 1                  # ragged rectangles
    ref = np.asarray(jax_ax(dtype))
    packed = pack_blocks(mid["blocks"], rects, tdt)
    got = midmv(packed, mid["doffs"], rects, geo.bricks, bs,
                torch.as_tensor(mid["x"])).numpy()
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_midmv_matches_full_blocks(mid, dtype):
    """Packed rectangles vs the full (k, bs, bs, NB) blocks in the same
    storage dtype: the dropped slot pairs are exactly zero."""
    tdt = DTYPES[dtype][0]
    geo, bs = mid["geo"], mid["bs"]
    full = torch.as_tensor(mid["blocks"]).to(torch.float32).to(tdt)
    x = torch.as_tensor(mid["x"])
    ref = brick_block_matvec(full, mid["doffs"], geo.bricks, x)
    got = midmv_plain(pack_blocks(mid["blocks"], mid["rects"], tdt),
                      mid["doffs"], mid["rects"], geo.bricks, bs, x)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_midmv_matches_csr(mid):
    geo, bs = mid["geo"], mid["bs"]
    fid = mid["slot"] * geo.num_bricks + mid["cd_brick"]
    x = np.zeros(bs * geo.num_bricks, np.float32)
    x[fid] = mid["x"][:len(fid)]
    y = midmv(pack_blocks(mid["blocks"], mid["rects"], torch.float32),
              mid["doffs"], mid["rects"], geo.bricks, bs,
              torch.as_tensor(x)).numpy()
    ref = mid["Ac"] @ x[fid].astype(np.float64)
    assert np.abs(y[fid] - ref).max() <= 1e-5 * np.abs(ref).max()
    pad = np.ones(len(x), bool)
    pad[fid] = False
    assert np.all(y[pad] == 0)


def test_packed_buffer_holds_only_used_rectangles(mid):
    geo, rects = mid["geo"], mid["rects"]
    NB = geo.num_bricks
    packed = pack_blocks(mid["blocks"], rects, torch.bfloat16)
    used = sum(r1 * r2 * NB for r1, r2 in rects)
    assert packed.shape == (used,)
    assert used < mid["blocks"].size            # smaller than full blocks
    starts, total = packed_starts(rects, NB)
    assert total == used and starts[0] == 0
    k = len(rects) // 2
    r1, r2 = rects[k]
    want = torch.as_tensor(np.ascontiguousarray(
        mid["blocks"][k, :r1, :r2], np.float32)).to(torch.bfloat16)
    assert torch.equal(packed[starts[k]:starts[k] + r1 * r2 * NB],
                       want.reshape(-1))


def test_midmv_wrapper_raises_off_cpu_and_cuda(mid):
    geo, bs = mid["geo"], mid["bs"]
    packed = torch.empty(4, device="meta")
    x = torch.empty(bs * geo.num_bricks, device="meta")
    with pytest.raises(ValueError, match="devices"):
        midmv(packed, mid["doffs"], mid["rects"], geo.bricks, bs, x)
