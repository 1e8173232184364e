"""The port's own copy of the host setup (saamge_tpu_torch/{fem,topology,
setup,solve,utils,native}, api.SpectralAMGSolver) against the JAX
package's host setup: the same setup product, exactly, on three
problems; and a scan that no port module imports the JAX package or JAX."""

import ast
import glob
import importlib
import os

import numpy as np
import pytest
import scipy.sparse as sp

from saamge_tpu_torch import api as port_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}")
            for name in ("api", "config", "fem.assemble", "fem.mesh",
                         "topology.part")}


def _solver(pkg, mesh, coef, opts_kw, **solver_kw):
    m = _mods(pkg)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = m["fem.assemble"].build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    opts = m["config"].SolverOptions(**opts_kw)
    s = m["api"].SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                                   **solver_kw)
    return s.ml


def _jax_flagship(n, brick, supers):
    """The port's flagship_problem, built with the JAX package."""
    m = _mods("saamge_tpu")
    nb = n // brick
    mesh = m["fem.mesh"].hex_mesh(n)
    coefs = 10.0 ** np.random.default_rng(7).uniform(-2, 2,
                                                      mesh.num_elements)
    part = m["topology.part"].partition_cartesian_3d(mesh.elem_centers(),
                                                     nb, nb, nb)
    return _solver(
        "saamge_tpu", mesh, coefs,
        dict(num_levels=3, correct_nulspace=False, first_theta=1e-4,
             theta=1e-4, nu_relax=[3, 1], device_setup=False),
        partitioning=part,
        coarse_part_override=lambda level: m["topology.part"]
        .partition_cartesian_bricks((nb,) * 3, supers))


def _jax_hexkway(n, epa, levels):
    """The port's general_problem, built with the JAX package."""
    m = _mods("saamge_tpu")
    mesh = m["fem.mesh"].hex_mesh(n)
    coef = 10.0 ** np.random.default_rng(7).uniform(-2, 2,
                                                     mesh.num_elements)
    return _solver(
        "saamge_tpu", mesh, coef,
        dict(num_levels=levels, correct_nulspace=False, first_theta=1e-4,
             theta=1e-4, nu_relax=[3, 1], first_elems_per_agg=epa,
             elems_per_agg=epa, device_setup=False))


def _quad(pkg):
    m = _mods(pkg)
    return _solver(pkg, m["fem.mesh"].quad_mesh(20),
                   m["api"].checkerboard_coef,
                   dict(num_levels=3, correct_nulspace=False,
                        first_elems_per_agg=16, elems_per_agg=4))


def _max_diff(a, b) -> float:
    if sp.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape
        d = abs(a - b)
        return float(d.max()) if d.nnz else 0.0
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) if a.size else 0.0


def _assert_same_product(ml_port, ml_jax):
    dims = [lv.tg_data.Ac.shape[0] for lv in ml_port.levels]
    assert dims == [lv.tg_data.Ac.shape[0] for lv in ml_jax.levels]
    for lp, lj in zip(ml_port.levels, ml_jax.levels):
        tp, tj = lp.tg_data, lj.tg_data
        for name in ("tent_interp", "interp", "Ac"):
            assert _max_diff(getattr(tp, name), getattr(tj, name)) == 0, name
        assert _max_diff(lp.A, lj.A) == 0
        for name in ("roots", "dinv"):
            assert _max_diff(getattr(tp.poly_data, name),
                             getattr(tj.poly_data, name)) == 0, name


@pytest.mark.parametrize("problem", ["brick", "hexkway", "quad"])
def test_host_setup_product_identical(problem):
    if problem == "brick":
        ml, _, _, supers = port_api.flagship_problem(n=8, brick=2,
                                                     supers=(2, 2, 2))
        ref = _jax_flagship(8, 2, supers)
    elif problem == "hexkway":
        ml = port_api.general_problem(n=10, elems_per_agg=64)[0]
        ref = _jax_hexkway(10, 64, 3)
    else:
        ml, ref = _quad("saamge_tpu_torch"), _quad("saamge_tpu")
    assert len(ml.levels) == 2
    _assert_same_product(ml, ref)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


# host-only modules copied with ``cp``, only their imports rewritten
HOST_COPIES = ("fem/coefficients.py", "fem/helmholtz.py", "fem/vis.py",
               "fem/glvis.py", "utils/serialize.py")


@pytest.mark.parametrize("module", HOST_COPIES)
def test_host_copy_differs_only_in_imports(module):
    with open(os.path.join(REPO, "saamge_tpu", module)) as f:
        orig = f.read().splitlines()
    with open(os.path.join(REPO, "saamge_tpu_torch", module)) as f:
        copy = f.read().splitlines()
    assert len(orig) == len(copy)
    for a, b in zip(orig, copy):
        if a != b:
            assert "import" in a and \
                a.replace("saamge_tpu.", "saamge_tpu_torch.") == b, (a, b)


def test_port_imports_no_jax_package():
    files = glob.glob(os.path.join(REPO, "saamge_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py"),
                                         os.path.join(REPO, "chip_profile.py")]
    assert len(files) > 30
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {f"saamge_tpu_torch/{m}" for m in HOST_COPIES} <= rel
    # the scale setup's device modules and the drivers' package
    assert {"saamge_tpu_torch/setup/device_rap.py",
            "saamge_tpu_torch/fem/assemble_device.py",
            "saamge_tpu_torch/drivers/__init__.py",
            "saamge_tpu_torch/drivers/run_scale_setup.py"} <= rel
    # the shard mesh and the sharded structured solve
    assert {f"saamge_tpu_torch/parallel/{m}.py" for m in
            ("__init__", "mesh", "structured_sharded", "checks")} <= rel
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("saamge_tpu", "jax", "jaxlib")]
    assert not bad, bad
