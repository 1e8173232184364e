"""The box contractions (ops/contract.py; on the CPU their plain
versions) and the structured ``use_pallas_contract`` configuration
against the JAX package: ``contract_R`` / ``contract_P`` against the
Pallas kernels in interpret mode on tile-padded tent blocks, and the
port's apply_R / apply_P / PCG against the JAX compile_structured with
``use_pallas_contract=True`` on the n=16 3-level setup of the other
port tests (rel <= 1e-5, PCG within one iteration).  Also: the slot
ranges of contract P cover every tent nonzero, contract R's by-slot
node lists hold each nonzero once, a numpy replay of contract R's launch
plan (csrc/contract.cu) writes each output once with a fixed-order sum
that matches the plain version (rel <= 1e-6), and the cached box-fold
index gives the old fold bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops import pallas_contract as JPC
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_pcg_solve)
from saamge_tpu_torch.convert import from_jax_arrays
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.ops.contract import (contract_P, contract_P_plain,
                                           contract_R, contract_R_plain,
                                           contract_R_plan, extract_boxes,
                                           fold_boxes, fold_index,
                                           slot_lists)
from saamge_tpu_torch.ops.window import slot_ranges

torch.set_num_threads(1)
F32, BF16 = torch.float32, torch.bfloat16


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("bs,box,NB,dtype", [(5, 27, 130, "f32"),
                                             (3, 125, 64, "bf16")])
def test_contract_matches_jax_kernels(bs, box, NB, dtype):
    rng = np.random.default_rng(bs)
    Rst = rng.standard_normal((bs, box, NB)).astype(np.float32)
    boxes = rng.standard_normal((box, NB)).astype(np.float32)
    xc = rng.standard_normal((bs, NB)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    Rj = JPC.pad_rst(jnp.asarray(Rst, jdt))
    assert Rj.shape != Rst.shape                   # tile padding
    # the port strips the padding, as convert.from_jax_arrays does
    Rt = torch.as_tensor(np.array(Rj, np.float32)[:, :box, :NB]).to(
        F32 if dtype == "f32" else BF16)
    y = contract_R(Rt, torch.as_tensor(boxes)).numpy()
    C = contract_P(Rt, torch.as_tensor(xc)).numpy()
    assert y.shape == (bs, NB) and C.shape == (box, NB)
    assert _rel(y, JPC.contract_R(Rj, jnp.asarray(boxes),
                                  interpret=True)) <= 1e-5
    assert _rel(C, JPC.contract_P(Rj, jnp.asarray(xc), box,
                                  interpret=True)) <= 1e-5


@pytest.fixture(scope="module")
def setup():
    ml, b, geo, supers = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    jgeo = JS.BrickGeometry(geo.bricks, geo.brick_elems)
    hj = JS.compile_structured(
        ml, jgeo, mid_dtype=jnp.bfloat16, smoother_dtype=jnp.bfloat16,
        rp_dtype=jnp.float32, super_bricks=supers, use_pallas_contract=True,
        wavefront=True)
    h = compile_structured(ml, geo, supers, rp_dtype=F32,
                           use_pallas_contract=True, device="cpu")
    return ml, b, geo, supers, hj, h


def test_extract_boxes_matches_jax(setup):
    _, _, geo, _, _, _ = setup
    r = np.random.default_rng(1).standard_normal(
        int(np.prod(geo.nodes))).astype(np.float32)
    got = extract_boxes(torch.as_tensor(r), geo.bricks, geo.brick_elems)
    ref = JS.extract_boxes(jnp.asarray(r).reshape(geo.nodes),
                           geo.brick_elems, geo.bricks)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_apply_R_P_match_jax(setup):
    _, _, geo, _, hj, h = setup
    assert h.contract and h.Rst.dtype == F32 and hj.Rst_pad is not None
    rng = np.random.default_rng(2)
    r = rng.standard_normal(h.n).astype(np.float32)
    xc = rng.standard_normal(h.n_flat).astype(np.float32)
    assert _rel(h.apply_R(torch.as_tensor(r)),
                hj.apply_R(jnp.asarray(r))) <= 1e-5
    assert _rel(h.apply_P(torch.as_tensor(xc)),
                hj.apply_P(jnp.asarray(xc))) <= 1e-5


def test_contract_slice_pcg_matches_jax(setup):
    _, b, _, _, hj, h = setup
    bt, bj = torch.as_tensor(b, dtype=F32), jnp.asarray(b, jnp.float32)
    for tol in (1e-6, 1e-8):
        it = struct_pcg_solve(h, bt, rel_tol=tol, max_iter=60)[1]
        itj = int(JS.struct_pcg_solve(hj, bj, rel_tol=tol, max_iter=60)[1])
        assert abs(it - itj) <= 1


def test_from_jax_arrays_strips_rst_pad(setup):
    _, _, geo, _, hj, h = setup
    d = {"A0.vals2": hj.A0.vals2, "A0s.vals2": hj.A0s.vals2,
         "dinv0h": hj.dinv0h,
         "taus0": np.concatenate([np.asarray(t) for t in hj.taus0]),
         "taus1": np.concatenate([np.asarray(t) for t in hj.taus1]),
         "Rst_pad": hj.Rst_pad, "A1d.blocks": hj.A1d.blocks,
         "dinv1": hj.dinv1, "Rst1": hj.Rst1, "flat_id": hj.flat_id,
         "flat_id2": hj.flat_id2, "Ainv": hj.Ainv}
    meta = {"offsets": hj.A0.offsets, "n": hj.n_fine, "hr": hj.A0.hr,
            "doffs": hj.A1d.doffs, "rects": hj.A1d.rects,
            "bricks": geo.bricks, "brick_elems": geo.brick_elems,
            "supers": hj.supers}
    hc = from_jax_arrays({k: np.asarray(v) for k, v in d.items()}, meta)
    assert hc.contract
    for name, buf in h.named_buffers():
        other = dict(hc.named_buffers())[name]
        assert other.dtype == buf.dtype and torch.equal(other, buf), name


def test_contract_hierarchy_registers_slot_ranges(setup):
    _, _, geo, _, _, h = setup
    rg = h.Rst_rng
    assert rg is not None and rg.dtype == torch.uint8
    assert tuple(rg.shape) == (2,) + tuple(h.Rst.shape[1:])
    assert torch.equal(rg, slot_ranges(h.Rst))
    s = torch.arange(h.bs)[:, None, None]
    inside = (s >= rg[0].long()) & (s < rg[1].long())
    # zeroing outside the ranges leaves the f32 tent unchanged
    assert torch.equal(torch.where(inside, h.Rst, 0.0), h.Rst)
    # ranges are tight: the first and last slot of a nonempty range hold
    # nonzeros
    ne = rg[1] > rg[0]
    first = h.Rst.gather(0, rg[0].long()[None])[0]
    last = h.Rst.gather(0, (rg[1].long() - 1).clamp(min=0)[None])[0]
    assert bool((first[ne] != 0).all()) and bool((last[ne] != 0).all())
    assert h.slot_lists is not None and h.slot_val.dtype == F32
    assert h.fold_idx.dtype == torch.int32
    assert h.fold_idx.shape == (int(np.prod(geo.nodes)),)


def _sparse_tent(rng, bs, box, NB, kind):
    Rst = rng.standard_normal((bs, box, NB)).astype(np.float32)
    if kind == "dense":
        return Rst
    lo = rng.integers(0, bs, (box, NB))
    ln = rng.integers(0, 4, (box, NB))
    ln[rng.random((box, NB)) < 0.25] = 0
    s = np.arange(bs)[:, None, None]
    return np.where((s >= lo) & (s < lo + ln), Rst, 0).astype(np.float32)


def _replay_R(lists, boxes):
    """contract R as csrc/contract.cu computes it from the slot lists
    under its plan: each task's outputs, g lanes an output, lane l adding
    entries l, l + g, .. of the list in f32, then a butterfly over the g
    lanes.  Returns the (bs, NB) sums and how often each output was
    written."""
    box, NB = boxes.shape
    order, start, val, node = (t.numpy() for t in lists[:4])
    plan = contract_R_plan(len(order), lists.nlong, lists.nshort)
    y = np.zeros(len(order), np.float32)
    written = np.zeros(len(order), np.int64)
    for t in range(plan.tasks):
        k0, k1, g = plan.task(t)
        assert 0 <= k0 < k1 <= len(order) and k1 - k0 <= 32 // g
        for k in range(k0, k1):
            o = order[k]
            part = np.zeros(g, np.float32)
            for lane in range(g):
                for j in range(start[k] + lane, start[k + 1], g):
                    part[lane] = part[lane] + val[j] * boxes[node[j], o % NB]
            off = g // 2
            while off:
                part = part + part[np.arange(g) ^ off]
                off //= 2
            y[o] = part[0]
            written[o] += 1
    return y.reshape(-1, NB), written


def _check_lists(lists, Rst):
    """Each nonzero (c, b, n) of Rst is one list entry of output (c, n),
    with its value; the lists ascend in b and the ranks sort the lengths,
    longest first, into their classes."""
    bs, box, NB = Rst.shape
    order, start, val, node = (t.numpy() for t in lists[:4])
    assert np.array_equal(np.sort(order), np.arange(bs * NB))
    L = np.diff(start)
    assert (np.diff(L) <= 0).all()
    assert lists.nlong == (L > 8).sum() and lists.nshort == (L > 1).sum()
    o = np.repeat(order, L)
    c, n, b = o // NB, o % NB, node.astype(np.int64)
    count = np.zeros(Rst.shape, np.int64)
    np.add.at(count, (c, b, n), 1)
    assert np.array_equal(count, (Rst != 0).astype(np.int64))
    assert np.array_equal(val, Rst[c, b, n].astype(np.float32))
    within = np.repeat(start[:-1], L)[1:] != np.arange(1, len(b))
    assert (b[1:][within] > b[:-1][within]).all()


@pytest.mark.parametrize("bs,box,NB,kind", [
    (5, 27, 130, "sparse"), (3, 125, 64, "sparse"),
    (5, 27, 130, "dense"), (3, 125, 64, "dense")])
def test_contract_R_plan_replay(bs, box, NB, kind):
    rng = np.random.default_rng(box + NB)
    Rst = _sparse_tent(rng, bs, box, NB, kind)
    boxes = rng.standard_normal((box, NB)).astype(np.float32)
    lists = slot_lists(torch.as_tensor(Rst))
    _check_lists(lists, Rst)
    y, written = _replay_R(lists, boxes)
    assert (written == 1).all()
    ref = contract_R_plain(torch.as_tensor(Rst), torch.as_tensor(boxes))
    assert _rel(y, ref.numpy()) <= 1e-6


def test_contract_R_plan_replay_on_the_tent(setup):
    _, _, _, _, _, h = setup
    rng = np.random.default_rng(3)
    bs, box, NB = h.Rst.shape
    lists = h.slot_lists
    assert lists.nlong > 0 and lists.nshort < bs * NB      # all classes
    _check_lists(lists, h.Rst.numpy())
    boxes = rng.standard_normal((box, NB)).astype(np.float32)
    y, written = _replay_R(lists, boxes)
    assert (written == 1).all()
    assert _rel(y, contract_R_plain(h.Rst, torch.as_tensor(boxes))) <= 1e-6


@pytest.mark.parametrize("outputs,nlong,nshort", [
    (34560, 9000, 21000), (650, 0, 0), (650, 650, 650), (130, 7, 100)])
def test_contract_R_plan_covers_every_output_once(outputs, nlong, nshort):
    plan = contract_R_plan(outputs, nlong, nshort)
    assert plan.blocks * plan.threads >= plan.tasks * 32
    assert (plan.blocks - 1) * plan.threads < plan.tasks * 32
    seen = np.zeros(outputs, np.int64)
    for t in range(plan.tasks):
        k0, k1, g = plan.task(t)
        assert g == (32 if k0 < nlong else 8 if k0 < nshort else 1)
        assert k1 - k0 <= 32 // g
        seen[k0:k1] += 1
    assert (seen == 1).all()


def test_contract_R_plan_and_lists_refuse_what_they_cannot_hold():
    with pytest.raises(ValueError):
        contract_R_plan(100, 60, 50)
    with pytest.raises(ValueError):
        contract_R_plan(2 ** 26, 0, 0)
    with pytest.raises(ValueError):
        slot_lists(torch.ones(1, 2 ** 15 + 1, 1))


@pytest.mark.parametrize("bricks,be", [((3, 4, 5), (2, 3, 4)),
                                       ((4, 4, 4), (4, 4, 4))])
def test_fold_index_equals_the_old_fold(bricks, be):
    """The old fold_boxes rebuilt its index on every call: 3 x (arange,
    clamp, floor_divide, mul, sub) and one 6-index gather."""
    (BX, BY, BZ), (bx, by, bz) = bricks, be
    box, NB = (bx + 1) * (by + 1) * (bz + 1), BX * BY * BZ
    C = torch.as_tensor(np.random.default_rng(NB).standard_normal(
        (box, NB)).astype(np.float32))
    C6 = C.view(bx + 1, by + 1, bz + 1, BX, BY, BZ)
    idx = []
    for B, b in ((BX, bx), (BY, by), (BZ, bz)):
        g = torch.arange(B * b + 1)
        p = torch.clamp(g - 1, min=0) // b
        idx.append((p, g - p * b))
    (px, ux), (py, uy), (pz, uz) = idx
    old = C6[ux[:, None, None], uy[None, :, None], uz[None, None, :],
             px[:, None, None], py[None, :, None], pz[None, None, :]] \
        .reshape(-1)
    assert torch.equal(fold_boxes(C, fold_index(bricks, be)), old)


def test_plain_versions_ignore_the_slot_tables():
    rng = np.random.default_rng(9)
    Rst = torch.as_tensor(_sparse_tent(rng, 4, 27, 37, "sparse"))
    boxes = torch.as_tensor(rng.standard_normal((27, 37)), dtype=F32)
    xc = torch.as_tensor(rng.standard_normal((4, 37)), dtype=F32)
    assert torch.equal(contract_R(Rst, boxes, lists=slot_lists(Rst)),
                       contract_R_plain(Rst, boxes))
    assert torch.equal(contract_P(Rst, xc, ranges=slot_ranges(Rst)),
                       contract_P_plain(Rst, xc))
    assert torch.equal(contract_P(Rst, xc), contract_P_plain(Rst, xc))
