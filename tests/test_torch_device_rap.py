"""The port's device Galerkin product (saamge_tpu_torch/setup/device_rap.py)
on the CPU against the JAX device RAP (its unrolled ``_rap_jit`` and its
``lax.scan`` form ``_rap_scan_jit``) and against the host f64 product
interp.T A interp, on the same host setup (hex_mesh(8), Cartesian bricks,
as tests/test_device_rap.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from saamge_tpu.setup import device_rap as JR
from saamge_tpu.solve.structured import BrickGeometry as JGeometry

from saamge_tpu_torch.api import SpectralAMGSolver
from saamge_tpu_torch.config import SolverOptions
from saamge_tpu_torch.fem import assemble
from saamge_tpu_torch.fem.mesh import hex_mesh
from saamge_tpu_torch.parallel.mesh import ShardMesh
from saamge_tpu_torch.setup import device_rap as TR
from saamge_tpu_torch.solve.structured import BrickGeometry
from saamge_tpu_torch.topology.part import partition_cartesian_3d

torch.set_num_threads(1)


def _problem(n, nbs, seed=11, rap_override=None, smooth=False):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(seed)
    coefs = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), *nbs)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False,
                         first_nu_pro=1 if smooth else 0)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, rap_override=rap_override)
    geo = BrickGeometry(nbs, tuple(n // k for k in nbs))
    return s, b, geo


def _level0(s):
    lv0 = s.ml.levels[0]
    tg0 = lv0.tg_data
    return (lv0.A.tocsr(), lv0.rels, tg0.tent_interp.tocsr(),
            tg0.interp_data.mis_numcoarsedof)


@pytest.mark.parametrize("nbs", [(2, 2, 2), (2, 4, 1)])
def test_structured_rap_matches_jax_and_host(nbs):
    """Same nonzero pattern as the host product, values within 1e-5 of its
    max (f32), and within 1e-6 of the JAX device RAP's max."""
    s, _, geo = _problem(8, nbs)
    assert not s.ml.levels[0].tg_data.smooth_interp
    args = _level0(s)
    Ac_host = s.ml.levels[0].tg_data.Ac.tocsr()
    stats = {}
    Ac = TR.structured_rap(*args, geo, device="cpu", stats=stats)
    Ac_jax = JR.structured_rap(*args, JGeometry(geo.bricks,
                                                geo.brick_elems))
    scale = abs(Ac_host).max()
    assert Ac.shape == Ac_host.shape == Ac_jax.shape
    assert abs(Ac - Ac_host).max() <= 1e-5 * scale
    assert abs(Ac - Ac_jax).max() <= 1e-6 * scale
    assert Ac.nnz == Ac_host.nnz == Ac_jax.nnz
    assert stats["blocks_bytes"] == 4 * 27 * stats["bs"] ** 2 * geo.num_bricks


def _random_case(seed=0):
    """The asymmetric case of tests/test_device_rap.py: brick_elems
    (2, 3, 2), bricks (3, 2, 2), bs 4, all 27 offsets."""
    be, bricks, bs = (2, 3, 2), (3, 2, 2), 4
    nodes = tuple(B * b + 1 for B, b in zip(bricks, be))
    rng = np.random.default_rng(seed)
    vals3 = rng.standard_normal((27,) + nodes).astype(np.float32)
    rst6 = rng.standard_normal(
        (bs,) + tuple(b + 1 for b in be) + bricks).astype(np.float32)
    return be, bricks, vals3, rst6


@pytest.mark.parametrize("form", ["unrolled", "scan"])
def test_rap_blocks_match_jax_forms(form):
    be, bricks, vals3, rst6 = _random_case()
    offsets3 = TR.NEIGHBOURS
    if form == "unrolled":
        ref = JR._rap_jit(be, bricks, offsets3)(jnp.asarray(vals3),
                                                 jnp.asarray(rst6))
    else:
        ref = JR._rap_scan_jit(be, bricks)(
            jnp.asarray(vals3), jnp.asarray(np.asarray(offsets3, np.int32)),
            jnp.asarray(rst6))
    ref = np.asarray(ref)
    got = TR.rap_blocks(torch.as_tensor(vals3), torch.as_tensor(rst6), be,
                        offsets3).numpy()
    assert got.shape == ref.shape == (27, 4, 4, 12)
    assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())


def test_rap_blocks_partial_offsets_match_jax():
    """A 7-point subset of the offsets: only those diagonals enter AP."""
    be, bricks, vals3, rst6 = _random_case(seed=1)
    offsets3 = tuple(d for d in TR.NEIGHBOURS if sum(map(abs, d)) <= 1)
    keep = [TR.NEIGHBOURS.index(d) for d in offsets3]
    ref = np.asarray(JR._rap_jit(be, bricks, offsets3)(
        jnp.asarray(vals3[keep]), jnp.asarray(rst6)))
    got = TR.rap_blocks(torch.as_tensor(vals3[keep]), torch.as_tensor(rst6),
                        be, offsets3).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())


def test_override_solver_matches_host_and_jax():
    """A solver built with the port's override takes the host-RAP solver's
    iterations, and its Ac is within 1e-5 of the host and the JAX
    override's."""
    from saamge_tpu.api import SpectralAMGSolver as JSolver
    from saamge_tpu.config import SolverOptions as JOptions
    from saamge_tpu.fem import assemble as jassemble
    from saamge_tpu.fem.mesh import hex_mesh as jhex_mesh
    from saamge_tpu.topology.part import partition_cartesian_3d as jpart
    geo = BrickGeometry((2, 2, 2), (4, 4, 4))
    s_host, b, _ = _problem(8, (2, 2, 2), seed=3)
    override = TR.make_structured_rap_override(geo, device="cpu")
    s_dev, _, _ = _problem(8, (2, 2, 2), seed=3, rap_override=override)
    assert override.stats["bs"] > 0

    mesh = jhex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coefs = 10.0 ** np.random.default_rng(3).uniform(-1, 1,
                                                     mesh.num_elements)
    A, _, em, _, _ = jassemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    s_jax = JSolver(A, mesh, em, JOptions(num_levels=2, correct_nulspace=False,
                                         elems_per_agg=4, device_setup=False),
                    ess_attr_marker=ess,
                    partitioning=jpart(mesh.elem_centers(), 2, 2, 2),
                    rap_override=JR.make_structured_rap_override(
                        JGeometry((2, 2, 2), (4, 4, 4))))
    Ac_host = s_host.ml.levels[0].tg_data.Ac
    Ac_dev = s_dev.ml.levels[0].tg_data.Ac
    scale = abs(Ac_host).max()
    assert abs(Ac_dev - Ac_host).max() <= 1e-5 * scale
    assert abs(Ac_dev - s_jax.ml.levels[0].tg_data.Ac).max() <= 1e-5 * scale
    it_host = s_host.solve(b).iterations
    assert s_dev.solve(b).iterations == it_host
    assert s_jax.solve(b).iterations == it_host


def test_override_routes_to_host():
    """A smoothed interpolant and a non-stencil operator take the host
    product (the override returns None before any device work); the level
    >= 1 products too."""
    geo = BrickGeometry((2, 2, 2), (4, 4, 4))
    override = TR.make_structured_rap_override(geo, device="cpu")
    s, _, _ = _problem(8, (2, 2, 2), smooth=True)
    tg = s.ml.levels[0].tg_data
    assert tg.smooth_interp
    A = s.ml.levels[0].A
    assert override(A, tg, s.ml.levels[0].rels, 0) is None
    tg.smooth_interp = False
    assert override(A, tg, s.ml.levels[0].rels, 1) is None
    # a coupling two planes away in x is no 27-point neighbour
    n = A.shape[0]
    far = (geo.nodes[1] * geo.nodes[2]) * 2
    A_far = (A + sp.eye(n, k=far) * 1e-3 + sp.eye(n, k=-far) * 1e-3).tocsr()
    assert override(A_far, tg, s.ml.levels[0].rels, 0) is None
    assert TR.stencil_diagonals(A_far, geo)[0] is None
    with pytest.raises(ValueError, match="not stencil-structured"):
        TR.structured_rap(A_far, s.ml.levels[0].rels, tg.tent_interp,
                          tg.interp_data.mis_numcoarsedof, geo, device="cpu")
    # an operator of another size than geo's node grid
    assert TR.stencil_diagonals(A[:-1, :-1], geo)[0] is None


@pytest.mark.parametrize("nbs", [(2, 4, 1), (2, 2, 1)])
def test_non_brick_partition_raises(nbs):
    """A partition that is not geo's bricks (the same count of parts in
    another shape, or another count) raises ValueError through the
    override and structured_rap, as the JAX override does (its
    build_structured_interp raises outside the AssertionError route),
    from the host check before any device work."""
    geo = BrickGeometry((2, 2, 2), (4, 4, 4))
    s, _, _ = _problem(8, nbs)
    lv0 = s.ml.levels[0]
    tg = lv0.tg_data
    assert not tg.smooth_interp
    args = (lv0.rels, tg.tent_interp, tg.interp_data.mis_numcoarsedof)
    with pytest.raises(ValueError, match="not brick-structured"):
        TR.brick_tent(*args, geo)
    override = TR.make_structured_rap_override(geo, device="cpu")
    with pytest.raises(ValueError, match="not brick-structured"):
        override(lv0.A, tg, lv0.rels, 0)
    assert override.stats == {}
    with pytest.raises(ValueError, match="not brick-structured"):
        TR.structured_rap(lv0.A, *args, geo, device="cpu")
    j_override = JR.make_structured_rap_override(
        JGeometry((2, 2, 2), (4, 4, 4)))
    with pytest.raises(ValueError, match="not brick-structured"):
        j_override(lv0.A, tg, lv0.rels, 0)


def test_card_and_sharded_raise():
    geo = BrickGeometry((2, 2, 2), (4, 4, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TR.make_structured_rap_override(geo)
    # the sharded product is ported (tests/test_torch_sharded_rap.py); it
    # raises where the shards do not divide the brick layers along x
    with pytest.raises(ValueError, match="do not divide"):
        TR.sharded_structured_rap(sp.identity(729, format="csr"), None,
                                  None, None, geo, ShardMesh(["cpu"] * 3))
