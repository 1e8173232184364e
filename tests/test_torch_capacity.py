"""The port's full-capacity structured solve (matrix-free fine operator,
packed mid matvec, bf16 coarsest inverse: ``compile_structured(mfree=...,
hbm_frugal=True, ainv_dtype=bf16)``) against the JAX package with the
flags of scripts/run_capacity.py, on the flagship n=16 host setup
product (4^3 bricks, superbricks (2,2,2)); the JAX Pallas kernels run in
interpret mode on the CPU."""

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
from saamge_tpu_torch.ops.mfree import MatrixFreeQ1

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOLS = (1e-6, 1e-8)
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def setup():
    ml, b, geo, supers, fac = flagship_problem(n=16, brick=4,
                                               supers=(2, 2, 2), mfree=True)
    return ml, b, geo, supers, fac


@pytest.fixture(scope="module")
def port_capacity(setup):
    ml, _, geo, supers, fac = setup
    return compile_structured(ml, geo, supers, mfree=fac, hbm_frugal=True,
                              ainv_dtype=BF16, device="cpu")


@pytest.fixture(scope="module")
def jax_capacity(setup):
    """scripts/run_capacity.py's compile_structured flags."""
    ml, _, geo, supers, fac = setup
    hj = JS.compile_structured(
        ml, JS.BrickGeometry(geo.bricks, geo.brick_elems),
        mid_dtype=jnp.bfloat16, smoother_dtype=jnp.bfloat16,
        rp_dtype=jnp.bfloat16, fine_layout="flat", super_bricks=supers,
        window_contract=True, wavefront=True, mfree=fac, hbm_frugal=True,
        ainv_dtype=jnp.bfloat16)
    bj = jnp.asarray(setup[1], jnp.float32)
    y = np.asarray(JS.struct_vcycle_apply(hj, bj))
    its = [int(JS.struct_pcg_solve(hj, bj, rel_tol=t, max_iter=60)[1])
           for t in TOLS]
    return hj, y, its


def _port_solves(h, b):
    bt = torch.as_tensor(b, dtype=torch.float32)
    y = struct_vcycle_apply(h, bt).numpy()
    its = [struct_pcg_solve(h, bt, rel_tol=t, max_iter=60)[1] for t in TOLS]
    return y, its


def test_capacity_matches_jax(setup, port_capacity, jax_capacity):
    """bf16 smoother field, tent, mid blocks and coarsest inverse: the
    port's rounding points differ from the TPU kernels' (f32 mid
    products, no bf16 window truncation), so the V-cycle agrees to the
    bf16 class and PCG to within one iteration."""
    _, y_ref, it_ref = jax_capacity
    y, its = _port_solves(port_capacity, setup[1])
    assert np.abs(y - y_ref).max() <= 1e-2 * np.abs(y_ref).max()
    for it, itr in zip(its, it_ref):
        assert abs(it - itr) <= 1
    assert its[0] <= its[1]


def test_capacity_true_residual(setup, port_capacity):
    """As tests/test_mfree.py test_full_mfree_capacity_pcg: with no
    stored fine operator the solve still reaches the tolerance against
    the assembled f64 operator."""
    ml, b, _, _, _ = setup
    x, it, _ = struct_pcg_solve(port_capacity,
                                torch.as_tensor(b, dtype=torch.float32),
                                rel_tol=1e-6, max_iter=80)
    rel = np.linalg.norm(b - ml.levels[0].A @ x.double().numpy()) \
        / np.linalg.norm(b)
    assert rel < 1e-4, rel
    assert 0 < it <= 10


def test_capacity_holds_no_stored_operator(setup, port_capacity):
    h = port_capacity
    assert isinstance(h.A0, MatrixFreeQ1) and isinstance(h.A0s, MatrixFreeQ1)
    assert h.A0.c_h.dtype == torch.float32 and h.A0s.c_h.dtype == BF16
    assert h.A1_blocks is None and h.Ainv.dtype == BF16
    k1, NB = len(h.doffs), h.geo.num_bricks
    for name, buf in h.named_buffers():
        assert buf.dim() <= 2 or name in ("Rst", "Rst_rng", "Rst1"), name
        assert tuple(buf.shape) != (27, h.n), name
        assert tuple(buf.shape) != (k1, h.bs, h.bs, NB), name
    assert h.A1_packed.numel() == sum(r1 * r2 * NB for r1, r2 in h.rects)
    flag = compile_structured(setup[0], setup[2], setup[3], device="cpu")
    nbytes = {m: sum(b.numel() * b.element_size()
                     for b in hh.buffers()) for m, hh in
              (("flagship", flag), ("capacity", h))}
    diags = flag.A0_vals.numel() * (4 + 2)      # f32 + bf16 diagonals
    assert nbytes["capacity"] <= nbytes["flagship"] - diags


@pytest.mark.parametrize("variant", ["mfree_only", "frugal_only"])
def test_capacity_options_alone_match_flagship(setup, variant):
    """Each option alone, all storage f32: ``mfree`` swaps the stored
    smoother twin for the matrix-free one (same operator, sums
    reassociated), ``hbm_frugal`` swaps the resident mid chain for
    chained packed matvecs (same op order)."""
    ml, b, geo, supers, fac = setup
    f32 = dict(smoother_dtype=torch.float32, rp_dtype=torch.float32,
               mid_dtype=torch.float32)
    ref = compile_structured(ml, geo, supers, device="cpu", **f32)
    kw = {"mfree": fac} if variant == "mfree_only" else {"hbm_frugal": True}
    h = compile_structured(ml, geo, supers, device="cpu", **kw, **f32)
    if variant == "mfree_only":
        assert isinstance(h.A0s, MatrixFreeQ1) and h.A0_vals is not None
    else:
        assert h.A1_blocks is None and h.A0s_vals is not None
    y_ref, it_ref = _port_solves(ref, b)
    y, its = _port_solves(h, b)
    assert np.abs(y - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
    assert its == it_ref


def test_from_jax_arrays_equals_compile_capacity(setup, port_capacity,
                                                 jax_capacity):
    hj = jax_capacity[0]
    geo = setup[2]
    d = {"A0s.c_h": hj.A0s.c_h, "A0s.m_h": hj.A0s.m_h,
         "A0m.c_h": hj.A0m.c_h, "A0m.m_h": hj.A0m.m_h,
         "K": np.asarray(hj.A0s.K), "dinv0h": hj.dinv0h,
         "taus0": np.concatenate([np.asarray(t) for t in hj.taus0]),
         "taus1": np.concatenate([np.asarray(t) for t in hj.taus1]),
         "Wc.rstw": hj.Wc[0], "dinv1": hj.dinv1, "Rst1": hj.Rst1,
         "flat_id": hj.flat_id, "flat_id2": hj.flat_id2, "Ainv": hj.Ainv}
    d = {k: np.asarray(v) for k, v in d.items()}
    d["A1kC"] = [np.asarray(a) for a in hj.A1kC]
    meta = {"offsets": hj.A0.offsets, "n": hj.n_fine, "hr": hj.A0s.hr,
            "doffs": hj.A1d.doffs, "rects": hj.A1d.rects,
            "bricks": geo.bricks, "brick_elems": geo.brick_elems,
            "supers": hj.supers}
    assert hj.Rst.shape[1:] == (1, 1)       # the JAX tent placeholder
    hc = from_jax_arrays(d, meta)
    h = port_capacity
    mine = dict(h.named_buffers())
    theirs = dict(hc.named_buffers())
    assert sorted(mine) == sorted(theirs)
    for name, buf in mine.items():
        assert theirs[name].dtype == buf.dtype, name
        assert torch.equal(theirs[name], buf), name
    for attr in ("offsets", "K", "n", "geo", "supers", "taus0", "taus1",
                 "doffs", "rects"):
        assert getattr(hc, attr) == getattr(h, attr), attr


_NO_JAX = r"""
import importlib.abc, sys

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, _BlockJax())
import numpy as np, torch
torch.set_num_threads(1)
from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_pcg_solve)
ml, b, geo, supers, fac = flagship_problem(n=8, brick=2, supers=(2, 2, 2),
                                           mfree=True)
h = compile_structured(ml, geo, supers, mfree=fac, hbm_frugal=True,
                       ainv_dtype=torch.bfloat16, device="cpu")
assert h.A1_blocks is None
bt = torch.as_tensor(b, dtype=torch.float32)
x, it, nom = struct_pcg_solve(h, bt, rel_tol=1e-8)
res = np.linalg.norm(b - ml.levels[0].A @ x.double().numpy())
assert 0 < it < 20 and res <= 1e-5 * np.linalg.norm(b), (it, res)
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print("NOJAX_OK", it)
"""


def test_capacity_runs_without_jax():
    """The capacity path (host setup with the matrix-free factors, n=8
    slice, PCG) imports no JAX module: the machine with the card has
    none."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
