"""The port's sharded Galerkin product
(saamge_tpu_torch/setup/device_rap.sharded_structured_rap) on shard
meshes of 1, 2 and 4 CPU shards, against the host f64 product, the
port's one-device ``structured_rap`` and the JAX
``sharded_structured_rap`` on its virtual CPU mesh (tests/conftest.py),
on the same host setup (hex_mesh(8), bricks (4, 2, 2))."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

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
NBS = (4, 2, 2)


@pytest.fixture(scope="module")
def level0():
    n = 8
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coefs = 10.0 ** np.random.default_rng(11).uniform(-1, 1,
                                                      mesh.num_elements)
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), *NBS)
    s = SpectralAMGSolver(
        A, mesh, em, SolverOptions(num_levels=2, correct_nulspace=False,
                                   elems_per_agg=4, device_setup=False),
        ess_attr_marker=ess, partitioning=part)
    lv0 = s.ml.levels[0]
    tg0 = lv0.tg_data
    args = (lv0.A.tocsr(), lv0.rels, tg0.tent_interp.tocsr(),
            tg0.interp_data.mis_numcoarsedof)
    geo = BrickGeometry(NBS, tuple(n // k for k in NBS))
    return args, tg0.Ac.tocsr(), geo


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sharded_rap_matches_host_and_jax(level0, P):
    """Same nonzero pattern as the host product and values within 1e-5
    of its max; within 1e-6 of the one-device product's max and of the
    JAX sharded product's on P virtual devices."""
    args, Ac_host, geo = level0
    Ac = TR.sharded_structured_rap(*args, geo, ShardMesh(["cpu"] * P))
    Ac_one = TR.structured_rap(*args, geo, device="cpu")
    jmesh = Mesh(np.array(jax.devices("cpu")[:P]), ("dp",))
    Ac_jax = JR.sharded_structured_rap(
        *args, JGeometry(geo.bricks, geo.brick_elems), jmesh)
    scale = abs(Ac_host).max()
    assert Ac.shape == Ac_host.shape == Ac_jax.shape
    assert Ac.nnz == Ac_host.nnz == Ac_jax.nnz == Ac_one.nnz
    assert abs(Ac - Ac_host).max() <= 1e-5 * scale
    assert np.array_equal(Ac.indices, Ac_host.indices)
    assert np.array_equal(Ac.indptr, Ac_host.indptr)
    assert abs(Ac - Ac_one).max() <= 1e-6 * scale
    assert abs(Ac - Ac_jax).max() <= 1e-6 * scale


def test_sharded_rap_raises(level0):
    """Shards that do not divide the brick layers, a partition that is
    not geo's bricks, and an operator that is not a stencil on geo's
    node grid each raise ValueError, before any device work."""
    args, _, geo = level0
    with pytest.raises(ValueError, match="do not divide"):
        TR.sharded_structured_rap(*args, geo, ShardMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="not brick-structured"):
        TR.sharded_structured_rap(
            *args, BrickGeometry((2, 2, 2), (4, 4, 4)),
            ShardMesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="not stencil-structured"):
        TR.sharded_structured_rap(
            *args, BrickGeometry((4, 2, 2), (1, 2, 2)),
            ShardMesh(["cpu"] * 2))
