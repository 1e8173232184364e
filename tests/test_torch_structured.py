"""The port's whole slice (saamge_tpu_torch: V-cycle and PCG of the
structured flagship hierarchy) against the JAX package on the same host
setup product (n=16, 4^3 bricks, superbricks (2,2,2), 3 levels,
theta=1e-4, nu_relax=[3,1], contrast 2, seed 7, device_setup=False);
the JAX Pallas kernels run in interpret mode on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saamge_tpu.solve import structured as JS

from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_pcg_solve, struct_vcycle_apply)
from saamge_tpu_torch.convert import from_jax_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOLS = (1e-6, 1e-8)


@pytest.fixture(scope="module")
def setup():
    ml, b, geo, supers = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    jgeo = JS.BrickGeometry(geo.bricks, geo.brick_elems)
    return ml, b, geo, supers, jgeo


@pytest.fixture(scope="module")
def jax_flagship(setup):
    """The bench.py flagship flags (flat fine layout)."""
    ml, _, _, supers, jgeo = setup
    return JS.compile_structured(
        ml, jgeo, mid_dtype=jnp.bfloat16, smoother_dtype=jnp.bfloat16,
        rp_dtype=jnp.bfloat16, super_bricks=supers, window_contract=True,
        wavefront=True)


def _jax_solves(hj, b):
    bj = jnp.asarray(b, jnp.float32)
    y = np.asarray(JS.struct_vcycle_apply(hj, bj))
    its = [int(JS.struct_pcg_solve(hj, bj, rel_tol=t, max_iter=60)[1])
           for t in TOLS]
    return y, its


def _port_solves(h, b):
    bt = torch.as_tensor(b, dtype=torch.float32)
    y = struct_vcycle_apply(h, bt).numpy()
    its = [struct_pcg_solve(h, bt, rel_tol=t, max_iter=60)[1] for t in TOLS]
    return y, its


def test_slice_matches_jax_flagship(setup, jax_flagship):
    """bf16 smoother twin, tent and mid blocks: the port's rounding
    points differ from the TPU kernels' (no bf16 window truncation, f32
    mid products), so the V-cycle agrees to the bf16 class and PCG to
    within one iteration."""
    ml, b, geo, supers, _ = setup
    y_ref, it_ref = _jax_solves(jax_flagship, b)
    y, its = _port_solves(compile_structured(ml, geo, supers, device="cpu"), b)
    assert np.abs(y - y_ref).max() <= 1e-2 * np.abs(y_ref).max()
    for it, itr in zip(its, it_ref):
        assert abs(it - itr) <= 1
    assert its[0] < its[1]


def test_slice_matches_jax_all_f32(setup):
    ml, b, geo, supers, jgeo = setup
    hj = JS.compile_structured(ml, jgeo, super_bricks=supers,
                               wavefront=True)
    y_ref, it_ref = _jax_solves(hj, b)
    f32 = torch.float32
    y, its = _port_solves(compile_structured(
        ml, geo, supers, smoother_dtype=f32, rp_dtype=f32, mid_dtype=f32,
        device="cpu"), b)
    assert np.abs(y - y_ref).max() <= 5e-4 * np.abs(y_ref).max()
    assert its == it_ref


def test_from_jax_arrays_equals_compile(setup, jax_flagship):
    ml, _, geo, supers, _ = setup
    hj = jax_flagship
    d = {"A0.vals2": hj.A0.vals2, "A0s.vals2": hj.A0s.vals2,
         "dinv0h": hj.dinv0h,
         "taus0": np.concatenate([np.asarray(t) for t in hj.taus0]),
         "taus1": np.concatenate([np.asarray(t) for t in hj.taus1]),
         "Rst": hj.Rst, "A1d.blocks": hj.A1d.blocks, "dinv1": hj.dinv1,
         "Rst1": hj.Rst1, "flat_id": hj.flat_id, "flat_id2": hj.flat_id2,
         "Ainv": hj.Ainv}
    meta = {"offsets": hj.A0.offsets, "n": hj.n_fine, "hr": hj.A0.hr,
            "doffs": hj.A1d.doffs, "rects": hj.A1d.rects,
            "bricks": geo.bricks, "brick_elems": geo.brick_elems,
            "supers": hj.supers}
    hc = from_jax_arrays({k: np.asarray(v) for k, v in d.items()}, meta)
    h = compile_structured(ml, geo, supers, device="cpu")
    for name, buf in h.named_buffers():
        other = dict(hc.named_buffers())[name]
        assert other.dtype == buf.dtype, name
        assert torch.equal(other, buf), name
    for attr in ("offsets", "n", "geo", "supers", "taus0", "taus1",
                 "doffs", "rects"):
        assert getattr(hc, attr) == getattr(h, attr), attr


def test_pcg_runtime_tolerance(setup):
    ml, b, geo, supers, _ = setup
    h = compile_structured(ml, geo, supers, device="cpu")
    bt = torch.as_tensor(b, dtype=torch.float32)
    _, it_loose, _ = struct_pcg_solve(h, bt, rel_tol=1e-2)
    _, it_tight, nom = struct_pcg_solve(h, bt, rel_tol=1e-8)
    assert it_tight > it_loose
    assert torch.isfinite(nom)


_NO_JAX = r"""
import importlib.abc, sys

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

BLOCKED = ("jax", "jaxlib", "saamge_tpu")
sys.meta_path.insert(0, _BlockJax())
import numpy as np, torch
torch.set_num_threads(1)
from saamge_tpu_torch import (compile_hierarchy, compile_structured,
                              flagship_problem, general_problem, pcg_solve,
                              struct_pcg_solve)
ml, b, geo, supers = flagship_problem(n=8, brick=2, supers=(2, 2, 2))
h = compile_structured(ml, geo, supers, device="cpu")
bt = torch.as_tensor(b, dtype=torch.float32)
x, it, nom = struct_pcg_solve(h, bt, rel_tol=1e-8)
res = np.linalg.norm(b - ml.levels[0].A @ x.double().numpy())
assert 0 < it < 20 and res <= 1e-5 * np.linalg.norm(b), (it, res)
import copy
ml2 = copy.copy(ml)
ml2.levels = ml.levels[:1]
for mlx, kw in ((ml2, {}), (ml, {"mid_format": "dense"})):
    h = compile_structured(mlx, geo, device="cpu", **kw)
    x, it2, nom = struct_pcg_solve(h, bt, rel_tol=1e-8)
    res = np.linalg.norm(b - ml.levels[0].A @ x.double().numpy())
    assert h.levels == len(mlx.levels) + 1, h.levels
    assert 0 < it2 < 20 and res <= 1e-5 * np.linalg.norm(b), (it2, res)
ml, A, b = general_problem(n=8, levels=2, elems_per_agg=64)
h = compile_hierarchy(ml, torch.float32, device="cpu")
x, itg, nom = pcg_solve(h, torch.as_tensor(b, dtype=torch.float32),
                        rel_tol=1e-8)
res = np.linalg.norm(b - A @ x.double().numpy())
assert 0 < itg < 30 and res <= 1e-5 * np.linalg.norm(b), (itg, res)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("NOJAX_OK", it, itg)
"""


def test_port_runs_without_jax():
    """The port (package, host setup, n=8 flagship slice, its two-level
    and dense-mid hierarchies, and hexkway general path, PCG) imports no
    module of JAX or of the JAX package saamge_tpu: the machine with the
    card has no JAX."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
