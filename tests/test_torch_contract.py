"""The box contractions (ops/contract.py; on the CPU their plain
versions) and the structured ``use_pallas_contract`` configuration
against the JAX package: ``contract_R`` / ``contract_P`` against the
Pallas kernels in interpret mode on tile-padded tent blocks, and the
port's apply_R / apply_P / PCG against the JAX compile_structured with
``use_pallas_contract=True`` on the n=16 3-level setup of the other
port tests (rel <= 1e-5, PCG within one iteration)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops import pallas_contract as JPC
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_pcg_solve)
from saamge_tpu_torch.convert import from_jax_arrays
from saamge_tpu_torch.ops.contract import (contract_P, contract_R,
                                           extract_boxes)

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
