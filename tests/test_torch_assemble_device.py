"""The port's device element assembly (saamge_tpu_torch/fem/assemble_device.py)
on the CPU against the JAX device assembly (saamge_tpu/fem/assemble_jax.py)
and the f64 host assembly, as tests/test_fem.py holds the JAX one."""

import numpy as np
import pytest
import torch

from saamge_tpu.fem import assemble_jax as JA
from saamge_tpu.fem.mesh import hex_mesh as jhex_mesh, quad_mesh as jquad_mesh

from saamge_tpu_torch.fem import assemble as host
from saamge_tpu_torch.fem import assemble_device as TA
from saamge_tpu_torch.fem.mesh import hex_mesh, quad_mesh

torch.set_num_threads(1)

MESHES = {"hex6": (hex_mesh, jhex_mesh, 6),
          "quad9": (quad_mesh, jquad_mesh, 9)}


def _coef(kind, ne):
    if kind == "scalar":
        return 1.0
    return 10.0 ** np.random.default_rng(5).uniform(-2, 2, ne)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("coef_kind", ["scalar", "per_element"])
def test_element_matrices_match_jax_and_host(mesh_name, coef_kind):
    make, jmake, n = MESHES[mesh_name]
    mesh, jmesh = make(n), jmake(n)
    coef = _coef(coef_kind, mesh.num_elements)
    # a chunk that leaves a short last chunk (no padding in the port)
    em = TA.diffusion_element_matrices(mesh, coef, chunk=50, device="cpu")
    em_jax = JA.diffusion_element_matrices(jmesh, coef, chunk=50)
    em_host = host.diffusion_element_matrices(mesh, coef)
    assert em.dtype == np.float32 and em.shape == em_host.shape
    scale = np.abs(em_host).max()
    assert np.abs(em - em_jax).max() <= 1e-6 * scale
    assert np.abs(em - em_host).max() <= 1e-5 * scale


def test_element_matrices_fine_mesh():
    """hex_mesh(48) (h = 1/48): the element-local coordinates keep the f32
    matrices within 2e-6 of the f64 host's; the absolute f32 coordinates
    of the JAX twin give 3.4e-6 here, and the error grows with n."""
    mesh = hex_mesh(48)
    coef = _coef("per_element", mesh.num_elements)
    em = TA.diffusion_element_matrices(mesh, coef, device="cpu")
    em_host = host.diffusion_element_matrices(mesh, coef)
    assert np.abs(em - em_host).max() <= 2e-6 * np.abs(em_host).max()


def test_build_discrete_problem_matches_host():
    mesh = hex_mesh(6)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A1, b1, _, _, e1 = host.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    A2, b2, em, _, e2 = TA.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, device="cpu")
    assert abs(A1 - A2).max() < 1e-5
    np.testing.assert_allclose(b1, b2, atol=1e-12)
    np.testing.assert_array_equal(e1, e2)
    assert em.dtype == np.float64


def test_device_argument():
    mesh = quad_mesh(2)
    with pytest.raises(ValueError, match="order 1"):
        TA.build_discrete_problem(mesh, order=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TA.diffusion_element_matrices(mesh)
