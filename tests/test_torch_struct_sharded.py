"""The port's x-slab sharded structured solve
(saamge_tpu_torch/parallel/) on meshes of CPU shards: against the JAX
sharded solve (saamge_tpu/parallel/structured_sharded.py on its
8-device virtual CPU mesh, tests/conftest.py, Pallas in interpret mode)
from the same host setup product (the port's flagship_problem, n=16,
4^3 bricks, superbricks (2,2,2)); against itself over 1, 2, 4 and 8
shards of one-plane slabs (n=8, one-element bricks); the distributed
against the replicated mid level; the superbrick against the dense-R1
coarsest; its memory split, preconditions and collectives; and the
production-regime check (the twin of tests/test_struct_sharded.py's)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from saamge_tpu.parallel import structured_sharded as JSS
from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_vcycle_apply)
from saamge_tpu_torch.parallel.checks import production_regime_sharded_check
from saamge_tpu_torch.parallel.mesh import ShardMesh, ShardTensor
from saamge_tpu_torch.parallel.structured_sharded import (
    gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
    mid_bytes_per_device, scatter_fine, shard_structured)
from saamge_tpu_torch.solve.device_pcg import solve_graphs

torch.set_num_threads(1)
TOLS = (1e-6, 1e-8)
F32 = dict(smoother_dtype=torch.float32, rp_dtype=torch.float32,
           mid_dtype=torch.float32)


def _mesh(P):
    return ShardMesh(["cpu"] * P)


def _port(h, b, P, **kw):
    """(V-cycle, PCG iterations at TOLS, solution at 1e-8) sharded."""
    hs = shard_structured(h, _mesh(P), **kw)
    bs = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bs)).numpy()
    solve = make_struct_sharded_pcg(hs, max_iter=80)
    its = [solve(bs, t)[1] for t in TOLS]
    x = gather_fine(hs, solve(bs, TOLS[-1])[0]).double().numpy()
    return y, its, x


def _rel(y, y_ref):
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


@pytest.fixture(scope="module")
def setup():
    return flagship_problem(n=16, brick=4, supers=(2, 2, 2))


@pytest.fixture(scope="module")
def jax_hierarchies(setup):
    """The JAX flagship flags on the z-lane layout (the JAX sharded path
    needs it), bf16 and all-f32."""
    ml, _, geo, supers = setup
    jgeo = JS.BrickGeometry(geo.bricks, geo.brick_elems)
    bf = jnp.bfloat16
    return {"bf16": JS.compile_structured(
                ml, jgeo, fine_layout="zlane", mid_dtype=bf,
                smoother_dtype=bf, rp_dtype=bf, super_bricks=supers,
                window_contract=True),
            "f32": JS.compile_structured(ml, jgeo, fine_layout="zlane",
                                         super_bricks=supers)}


# the port's rounding points differ from the TPU kernels' (f32 window
# values, f32 fine passes): the bf16 class, as tests/test_torch_structured
TOL = {"bf16": 1e-2, "f32": 5e-4}


@pytest.mark.parametrize("config,P", [("bf16", 2), ("bf16", 4),
                                      ("f32", 2), ("f32", 4)])
def test_sharded_matches_jax(setup, jax_hierarchies, config, P):
    ml, b, geo, supers = setup
    hj = JSS.shard_structured(jax_hierarchies[config],
                              Mesh(np.array(jax.devices("cpu")[:P]),
                                   ("dp",)))
    bj = JSS.scatter_fine(hj, b)
    y_ref = JSS.gather_fine(hj, JSS.make_struct_sharded_vcycle(hj)(bj))
    jsolve = JSS.make_struct_sharded_pcg(hj, max_iter=80)
    it_ref = [int(jsolve(bj, t)[1]) for t in TOLS]
    h = compile_structured(ml, geo, supers, device="cpu",
                           **(F32 if config == "f32" else {}))
    y, its, x = _port(h, b, P)
    assert _rel(y, y_ref) <= TOL[config]
    assert all(abs(a - c) <= 1 for a, c in zip(its, it_ref)), (its, it_ref)
    A = ml.levels[0].A
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4


@pytest.fixture(scope="module")
def one_plane():
    """One-element bricks: at 8 shards each slab is one plane thick, and
    the right neighbour's rows past its shared plane are its halo."""
    ml, b, geo, supers = flagship_problem(n=8, brick=1, supers=(2, 2, 2))
    h = compile_structured(ml, geo, supers, device="cpu")
    return h, b, _port(h, b, 1)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_device_count_invariant(one_plane, P):
    """Equal PCG iterations at 1, 2, 4 and 8 shards and the V-cycle
    within 1e-6 of one shard's (on the CPU bit-equal at 4 shards and
    3.9e-8 off at 2 and 8; with the replicated mid bit-equal at all)."""
    h, b, (y1, its1, _) = one_plane
    y, its, _ = _port(h, b, P)
    assert its == its1
    assert _rel(y, y1) <= 1e-6


def test_distributed_against_replicated_mid(setup):
    """The distributed mid (plain torch, x rounded through the bf16
    blocks as in JAX) against the replicated mid (the hierarchy's own
    resident chain, x in f32): the bf16 class, iterations within 1; the
    replicated route is the single-card cycle but for the root-by-root
    fine smoothing."""
    ml, b, geo, supers = setup
    h = compile_structured(ml, geo, supers, device="cpu")
    yd, itd, _ = _port(h, b, 2)
    yr, itr, _ = _port(h, b, 2, mid_replicated=True)
    assert _rel(yd, yr) <= 1e-3
    assert all(abs(a - c) <= 1 for a, c in zip(itd, itr))
    y1 = struct_vcycle_apply(h, torch.as_tensor(b, dtype=torch.float32))
    assert _rel(yr, y1.numpy()) <= 1e-5


def test_superbrick_against_dense_R1_coarsest(setup):
    """The superbrick tent blocks and the dense R1 are one restriction:
    the sharded superbrick chunks (2 shards) and the sharded R1 columns
    (4 shards) give the same V-cycle within 1e-5 and the same
    iterations."""
    ml, b, geo, supers = setup
    hsb = compile_structured(ml, geo, supers, device="cpu")
    hr1 = compile_structured(ml, geo, None, device="cpu")
    assert hsb.Rst1 is not None and hr1.R1 is not None
    ysb, itsb, _ = _port(hsb, b, 2)
    yr1, itr1, _ = _port(hr1, b, 4)
    assert _rel(ysb, yr1) <= 1e-5
    assert itsb == itr1
    hs = shard_structured(hr1, _mesh(4))
    assert hs.mid is None and hs.st.supers is None
    assert hs.shards[0].r1.shape == (hr1.R1.shape[0], hr1.n_flat // 4)


@pytest.mark.parametrize("P", [2, 4])
def test_mid_bytes_per_device(setup, P):
    ml, _, geo, supers = setup
    h = compile_structured(ml, geo, supers, device="cpu")
    total = sum(t.numel() * t.element_size()
                for t in (h.A1_blocks, h.dinv1, h.Rst1))
    acct = mid_bytes_per_device(shard_structured(h, _mesh(P)))
    assert 0 < acct["sharded"] <= total // P + total // 8
    ainv = h.Ainv.numel() * h.Ainv.element_size()
    assert ainv <= acct["replicated"] <= ainv + (1 << 20)
    rep = mid_bytes_per_device(shard_structured(h, _mesh(P),
                                                mid_replicated=True))
    assert rep["sharded"] == 0 and rep["replicated"] >= total + ainv


def test_preconditions_raise(setup):
    ml, _, geo, supers = setup
    h = compile_structured(ml, geo, supers, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        shard_structured(h, _mesh(3))
    ml2 = copy.copy(ml)
    ml2.levels = ml.levels[:1]
    with pytest.raises(ValueError, match="three-level"):
        shard_structured(compile_structured(ml2, geo, device="cpu"),
                         _mesh(2))
    dense = compile_structured(ml, geo, supers, mid_format="dense",
                               device="cpu")
    with pytest.raises(ValueError, match="distributed mid needs"):
        shard_structured(dense, _mesh(2), mid_replicated=False)
    assert shard_structured(dense, _mesh(2)).mid is not None


def test_matrix_free_operators():
    """A matrix-free PCG operator raises; a matrix-free smoother twin
    alone is replaced by the f32 diagonals, as in JAX."""
    ml, b, geo, supers, fac = flagship_problem(n=8, brick=2,
                                               supers=(2, 2, 2), mfree=True)
    frugal = compile_structured(ml, geo, supers, mfree=fac, hbm_frugal=True,
                                device="cpu")
    with pytest.raises(ValueError, match="stored diagonals"):
        shard_structured(frugal, _mesh(2))
    twin = compile_structured(ml, geo, supers, mfree=fac, device="cpu")
    hs = shard_structured(twin, _mesh(2))
    assert hs.shards[0].A0s_vals is hs.shards[0].A0_vals
    y, its, _ = _port(twin, b, 2)
    y_ref, its_ref, _ = _port(compile_structured(
        ml, geo, supers, device="cpu", smoother_dtype=torch.float32), b, 2)
    assert _rel(y, y_ref) <= 1e-5 and its == its_ref


def test_collectives():
    """psum adds in shard order (every shard the same bits), ppermute
    sends to the neighbour with zeros at the chain's end, all_gather
    stacks in shard order, and torch functions map over the shards."""
    mesh = _mesh(4)
    vals = [1e8, 1.0, -1e8, 1.0]     # f32: left to right gives exactly 1
    parts = [torch.tensor(v, dtype=torch.float32) for v in vals]
    tot = mesh.psum(parts)
    assert all(torch.equal(t, torch.tensor(1.0)) for t in tot)
    right = mesh.ppermute_right(parts)
    left = mesh.ppermute_left(parts)
    assert [float(t) for t in right] == [0.0, 1e8, 1.0, -1e8]
    assert [float(t) for t in left] == [1.0, -1e8, 1.0, 0.0]
    g = mesh.all_gather([torch.full((2,), float(d)) for d in range(4)], 1)
    assert torch.equal(g[3], torch.arange(4.0).expand(2, 4))
    x = ShardTensor([torch.ones(3) * d for d in range(4)])
    y = torch.zeros_like(x)
    torch.add(x, 2.0 * x, out=y)
    assert [float(t.sum()) for t in y] == [0.0, 9.0, 18.0, 27.0]
    assert isinstance(x.clone(), ShardTensor) and x.shape == (3,)


def test_tolerance_is_no_rebuild(setup):
    """A new tolerance reuses the hierarchy's one PCG runner."""
    ml, b, geo, supers = setup
    h = compile_structured(ml, geo, supers, device="cpu")
    hs = shard_structured(h, _mesh(2))
    bs = scatter_fine(hs, b)
    solve = make_struct_sharded_pcg(hs, max_iter=80)
    it6 = solve(bs)[1]
    it8 = solve(bs, 1e-8)[1]
    assert it8 > it6 and len(solve_graphs(hs).items) == 1


def test_production_regime_sharded():
    """The twin of tests/test_struct_sharded.py::test_production_regime
    _sharded: ns=24, bricks of 3, 2 shards."""
    out = production_regime_sharded_check(_mesh(2), ns=24, brick=3)
    assert out["iters"] == out["iters_ref"] and out["mid_distributed"]
    assert out["wf_diff"] <= 1e-3
