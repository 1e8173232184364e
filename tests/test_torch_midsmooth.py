"""Port mid-level chain (saamge_tpu_torch/ops/midsmooth.py) against the
JAX resident Pallas chain (pallas_midsmooth.mid_chain, interpret mode,
symmetry-halved packing as in the flagship) on the flagship n=16 mid
operator, and the plain brick-block matvec against the host CSR."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.ops.pallas_midsmooth import (mid_chain as jax_mid_chain,
                                             pad_vec, prep_blocksT,
                                             unpad_vec)
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import compile_structured, flagship_problem
from saamge_tpu_torch.ops.midsmooth import brick_block_matvec, mid_chain

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
    got = mid_chain(blocks, h.doffs, h.rects, h.geo.bricks, h.taus1,
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
