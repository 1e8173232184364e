"""The port's copies of the VTK writer and the GLVis client
(saamge_tpu_torch/fem/{vis,glvis}.py), as tests/test_vis.py checks the
JAX package's, and the written files against the JAX package's, byte
for byte."""

import os
import socket
import threading

import numpy as np

from saamge_tpu.fem import glvis as jax_glvis
from saamge_tpu.fem import vis as jax_vis
from saamge_tpu.fem.mesh import hex_mesh as jax_hex_mesh

from saamge_tpu_torch.api import (bdr_dof_flags, checkerboard_coef,
                                  geometric_partitioning)
from saamge_tpu_torch.fem import assemble, glvis, vis
from saamge_tpu_torch.fem.mesh import hex_mesh, quad_mesh, read_mfem_mesh


def test_vtk_outputs_equal_jax_package(tmp_path):
    mesh = quad_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, _, _, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    rels = geometric_partitioning(A, mesh, bdr_dof_flags(mesh, ess), 4)
    x = np.linspace(0, 1, mesh.num_dofs(1))
    for name, mod in (("port", vis), ("jax", jax_vis)):
        d = tmp_path / name
        d.mkdir()
        mod.save_partitioning(str(d / "parts.vtk"), mesh, rels.partitioning)
        mod.save_aggregates(str(d / "aggs.vtk"), mesh, rels)
        mod.save_solution(str(d / "sol.vtk"), mesh, x)
    for f in ("parts.vtk", "aggs.vtk", "sol.vtk"):
        txt = (tmp_path / "port" / f).read_text()
        assert txt.startswith("# vtk DataFile")
        assert "CELLS 64" in txt
        assert txt == (tmp_path / "jax" / f).read_text(), f
    assert "SCALARS AE" in (tmp_path / "port" / "aggs.vtk").read_text()
    gf = os.path.join(tmp_path, "x.gf")
    vis.write_gridfunction(gf, np.arange(5.0))
    np.testing.assert_allclose(vis.read_gridfunction(gf), np.arange(5.0))


def test_glvis_socket_protocol_roundtrip(tmp_path):
    """'solution\\n' + MFEM mesh v1.0 + GridFunction to a local fake
    server; the mesh section round-trips through the port's reader."""
    mesh = quad_mesh(4)
    x = np.arange(mesh.num_vertices, dtype=np.float64) * 0.5
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got = []

    def serve():
        conn, _ = srv.accept()
        buf = b""
        while True:
            d = conn.recv(65536)
            if not d:
                break
            buf += d
        got.append(buf.decode())
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    glvis.visualize_solution(mesh, x, host="127.0.0.1", port=port)
    t.join(timeout=10)
    srv.close()
    assert got, "server saw no data"
    payload = got[0]
    assert payload.startswith("solution\n")
    mesh_txt, gf_txt = payload[len("solution\n"):].split(
        "FiniteElementSpace", 1)
    mf = tmp_path / "m.mesh"
    mf.write_text(mesh_txt)
    m2 = read_mfem_mesh(str(mf))
    assert np.array_equal(m2.elements, mesh.elements)
    assert np.allclose(m2.vertices, mesh.vertices)
    assert np.array_equal(m2.boundary, mesh.boundary)
    vals = [float(v) for v in gf_txt.splitlines()
            if v and not any(c.isalpha() for c in v.split()[0][1:])
            and v[0] in "-0123456789"]
    assert np.allclose(vals, x)


def test_glvis_partitioning_l2_field_equals_jax_package():
    part = np.arange(hex_mesh(4).num_elements) % 8
    s = glvis.mfem_gf_str(hex_mesh(4), part.astype(float), l2=True)
    assert "L2_3D_P0" in s
    assert s == jax_glvis.mfem_gf_str(jax_hex_mesh(4), part.astype(float),
                                      l2=True)


def test_glvis_png_quicklook(tmp_path):
    m2 = quad_mesh(5)
    p2 = tmp_path / "q.png"
    glvis.plot_png(str(p2), m2, x=np.linspace(0, 1, m2.num_vertices),
                   title="2d")
    assert p2.stat().st_size > 1000
    m3 = hex_mesh(4)
    p3 = tmp_path / "h.png"
    glvis.plot_png(str(p3), m3, x=np.linspace(0, 1, m3.num_vertices),
                   title="slice")
    assert p3.stat().st_size > 1000
