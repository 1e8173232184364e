"""Port tent restriction / prolongation (saamge_tpu_torch/ops/window.py)
against the JAX package on the flagship n=16 setup: the XLA
apply_R / apply_P of a bf16-Rst hierarchy (same numerics: bf16 Rst,
f32 everything else), the Pallas window kernels (interpret mode; they
truncate window values to bf16), and the host tent CSR; window R's
launch plan and memoised geometry; window P's slot ranges."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import compile_structured, flagship_problem
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops import window as W
from saamge_tpu_torch.ops.window import (box_index, slot_ranges, window_P,
                                         window_P_plain, window_R,
                                         window_R_plan)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    ml, _, geo, supers = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    jgeo = JS.BrickGeometry(geo.bricks, geo.brick_elems)
    h_xla = JS.compile_structured(ml, jgeo, rp_dtype=jnp.bfloat16,
                                  super_bricks=supers)
    h_win = JS.compile_structured(ml, jgeo, rp_dtype=jnp.bfloat16,
                                  super_bricks=supers, window_contract=True)
    assert h_win.Wc is not None and h_xla.Wc is None
    h = compile_structured(ml, geo, supers, device="cpu")
    rng = np.random.default_rng(5)
    r = rng.standard_normal(h.n).astype(np.float32)
    xc = rng.standard_normal(h.n_flat).astype(np.float32)
    return ml, h, h_xla, h_win, r, xc


def _port(h, which, v):
    f = window_R if which == "R" else window_P
    return f(h.Rst, torch.as_tensor(v), h.geo.bricks,
             h.geo.brick_elems).numpy()


def _jax(hj, which, v):
    f = hj.apply_R if which == "R" else hj.apply_P
    return np.asarray(f(jnp.asarray(v)))


@pytest.mark.parametrize("which", ["R", "P"])
def test_window_matches_xla_apply(setup, which):
    _, h, h_xla, _, r, xc = setup
    v = r if which == "R" else xc
    ref = _jax(h_xla, which, v)
    got = _port(h, which, v)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("which", ["R", "P"])
def test_window_matches_pallas_window(setup, which):
    """Within the bf16-truncation class of the TPU window kernels."""
    _, h, _, h_win, r, xc = setup
    v = r if which == "R" else xc
    ref = _jax(h_win, which, v)
    got = _port(h, which, v)
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


def test_window_matches_tent_csr(setup):
    """With f32 tent blocks, R and P are the host tent P^T and P on the
    real (non-padding) coarse slots; padding slots restrict to zero."""
    ml, h, _, _, r, xc = setup
    h32 = compile_structured(ml, h.geo, h.supers, rp_dtype=torch.float32,
                             device="cpu")
    P = ml.levels[0].tg_data.tent_interp.tocsr()
    fid = h32.flat_id.numpy()
    rc = _port(h32, "R", r)
    rc_ref = P.T @ r.astype(np.float64)
    assert np.abs(rc[fid] - rc_ref).max() <= 1e-5 * np.abs(rc_ref).max()
    pad = np.ones(h32.n_flat, bool)
    pad[fid] = False
    assert np.all(rc[pad] == 0)
    xc_flat = np.zeros(h32.n_flat, np.float32)
    xc_flat[fid] = xc[:len(fid)]
    y = _port(h32, "P", xc_flat)
    y_ref = P @ xc[:len(fid)].astype(np.float64)
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


def test_box_index_matches_extract_boxes():
    """The plain versions' window map equals the JAX extract_boxes
    windows on a non-cubic brick grid."""
    bricks, be = (3, 2, 1), (2, 3, 4)
    nodes = tuple(B * b + 1 for B, b in zip(bricks, be))
    r3 = np.random.default_rng(2).standard_normal(nodes).astype(np.float32)
    ref = np.asarray(JS.extract_boxes(jnp.asarray(r3), be, bricks))
    idx = box_index(bricks, be, "cpu").numpy()
    np.testing.assert_array_equal(r3.reshape(-1)[idx], ref)


# the n=96 flagship / capacity tent, ragged grids (no side a multiple of
# the tile; odd and even BZ), and the n=16 one of the fixture
R_PLAN_SHAPES = [((12, 12, 12), (8, 8, 8), 20), ((5, 3, 7), (4, 4, 4), 13),
                 ((5, 3, 7), (8, 8, 8), 13), ((6, 5, 4), (8, 8, 8), 13),
                 ((4, 4, 4), (4, 4, 4), 9)]


@pytest.mark.parametrize("bricks,be,bs", R_PLAN_SHAPES)
def test_window_R_plan_covers_every_output_once(bricks, be, bs):
    plan = window_R_plan(bricks, be, bs)
    NB = int(np.prod(bricks))
    assert plan.smem <= _build.SMEM_MAX
    assert plan.threads <= W.MAX_THREADS
    assert plan.grid == (NB // bricks[2], -(-bs // W.SLOTS_PER_BLOCK))
    assert plan.grid[1] <= 65535
    # every (u-plane, v-range, brick pair) item has a thread
    items = (be[0] + 1) * plan.vs * ((bricks[2] + 1) // 2)
    assert plan.threads >= min(items, W.MAX_THREADS)
    got = np.concatenate([plan.block_outputs(bricks, bs, tx, g)
                          for tx in range(plan.grid[0])
                          for g in range(plan.grid[1])])
    assert len(got) == bs * NB
    np.testing.assert_array_equal(np.sort(got), np.arange(bs * NB))


def test_window_R_plan_n96_keeps_five_blocks_per_sm():
    """n=96: 144 z-lines x 5 slot groups; 41 KB of shared memory leaves
    room for five blocks on an SM."""
    plan = window_R_plan((12, 12, 12), (8, 8, 8), 20)
    assert plan.grid == (144, 5) and (plan.vs, plan.pitch) == (3, 109)
    assert 5 * (plan.smem + 1024) <= 228 * 1024


def test_window_R_plan_refuses_an_oversized_slab():
    with pytest.raises(ValueError, match="exceeds"):
        window_R_plan((2, 2, 40), (32, 32, 32), 20)


def test_window_geometry_is_memoised():
    key = ((5, 3, 7), (4, 4, 4), 13)
    geom, plan = W._geom(*key), W._R_plan(*key)
    assert W._geom(*key) is geom and W._R_plan(*key) is plan
    assert list(geom) == [5, 3, 7, 4, 4, 4, 13]
    assert list(plan) == list(window_R_plan(*key).ints())
    assert list(W._R_plan.__wrapped__(*key)) == list(plan)


def test_slot_ranges_cover_every_tent_nonzero(setup):
    """On the n=16 flagship tent every nonzero of Rst[:, w, p] lies in
    [lo, hi), and a node's nonzeros sit in one (brick, box node) pair
    (its MIS's master brick)."""
    _, h, _, _, _, _ = setup
    Rst = h.Rst
    rng = slot_ranges(Rst)
    assert rng.dtype == torch.uint8 and rng.shape == (2,) + Rst.shape[1:]
    assert torch.equal(rng, h.Rst_rng)
    lo, hi = rng.long()
    s = torch.arange(Rst.shape[0])[:, None, None]
    inside = (s >= lo) & (s < hi)
    nz = Rst != 0
    assert not torch.any(nz & ~inside)
    # each range is tight: its ends are nonzeros
    used = hi > lo
    assert torch.all(nz.gather(0, lo[None]).squeeze(0)[used])
    assert torch.all(nz.gather(0, (hi - 1).clamp(min=0)[None])
                     .squeeze(0)[used])
    assert torch.all(lo[~used] == 0) and torch.all(hi[~used] == 0)
    idx = box_index(h.geo.bricks, h.geo.brick_elems, "cpu")
    pairs = torch.zeros(h.n, dtype=torch.long).index_add_(
        0, idx.reshape(-1), used.reshape(-1).long())
    assert int(pairs.max()) == 1
    # few slots per node: the work the kernel does
    assert float((hi - lo).sum()) / h.n < 2.0


def test_slot_ranges_of_a_dense_Rst_are_all_slots():
    rst = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (13, 27, 6)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        rng = slot_ranges(rst.to(dt))
        assert torch.all(rng[0] == 0) and torch.all(rng[1] == 13)
    rst[:, 4, 2] = 0
    rst[:3, 5, 1] = 0
    rst[9:, 5, 1] = 0
    rng = slot_ranges(rst)
    assert (int(rng[0, 4, 2]), int(rng[1, 4, 2])) == (0, 0)
    assert (int(rng[0, 5, 1]), int(rng[1, 5, 1])) == (3, 9)
    with pytest.raises(ValueError, match="255"):
        slot_ranges(torch.ones(256, 1, 1))


@pytest.mark.parametrize("rp", ["bf16", "f32"])
def test_window_P_in_range_sums_equal_plain(setup, rp):
    """A torch emulation of the kernel, which sums only the slots inside
    each (brick, box node) range, equals window_P_plain."""
    ml, h, _, _, _, xc = setup
    if rp == "f32":
        h = compile_structured(ml, h.geo, h.supers, rp_dtype=torch.float32,
                               device="cpu")
    bricks, be = h.geo.bricks, h.geo.brick_elems
    Rst = h.Rst.to(torch.float32)
    lo, hi = h.Rst_rng.long()
    s = torch.arange(Rst.shape[0])[:, None, None]
    keep = (s >= lo) & (s < hi)
    xcv = torch.as_tensor(xc)
    C = (torch.where(keep, Rst, 0.0) * xcv.view(h.bs, 1, -1)).sum(0)
    idx = box_index(bricks, be, "cpu")
    got = torch.zeros(h.n).index_add_(0, idx.reshape(-1), C.reshape(-1))
    ref = window_P_plain(h.Rst, xcv, bricks, be)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    # the hierarchy's apply_P passes the table; on the CPU it runs plain
    assert torch.equal(h.apply_P(xcv), ref)
    assert torch.equal(window_P(h.Rst, xcv, bricks, be, ranges=h.Rst_rng),
                       ref)
