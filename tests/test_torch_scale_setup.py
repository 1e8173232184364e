"""The port's scale-setup driver (saamge_tpu_torch/drivers/run_scale_setup.py)
on the CPU at n=16, in a subprocess that blocks jax and saamge_tpu, against
the JAX driver scripts/run_scale_setup.py on the same flags (host setup)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n", "16", "--brick", "4", "--supers", "2"]

_RUN = r"""
import importlib.abc, json, sys

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

BLOCKED = ("jax", "jaxlib", "saamge_tpu")
sys.meta_path.insert(0, _BlockJax())
import torch
torch.set_num_threads(1)
from saamge_tpu_torch.drivers.run_scale_setup import main
small = SMALL + ["--device", "cpu"]
outs = [main(small),
        main(small + ["--device-rap", "--solve", "--hier-cache", CACHE]),
        main(small + ["--device-rap", "--solve", "--hier-cache", CACHE]),
        main(small + ["--device-rap", "--solve", "--frugal", "--mfree"])]
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("RESULT " + json.dumps(outs))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("scale") / "bundle.pkl")
    script = f"SMALL = {SMALL!r}\nCACHE = {cache!r}\n" + _RUN
    proc = subprocess.run([sys.executable, "-c", script],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def jax_run():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_scale_setup.py")]
        + SMALL + ["--host-setup"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_levels_match_jax_driver(runs, jax_run):
    plain, rap = runs[:2]
    assert jax_run["levels"] == [4913, 679, 57]
    for out in (plain, rap):
        assert out["levels"] == jax_run["levels"]
        assert out["ndof"] == jax_run["ndof"]
        assert out["nnz"] == jax_run["nnz"]
        assert out["platform"] == "cpu"
    # the finest product: the host's in the plain run, the device's with
    # --device-rap (the coarser one stays on the host)
    assert not plain["device_rap"]
    assert "setup.rap_device" not in plain["phases"]["timers"]
    assert rap["device_rap"] and "setup.rap_device" in rap["phases"]["timers"]
    assert "setup.rap" in rap["phases"]["timers"]
    assert rap["rap"]["bs"] > 0 and rap["rap"]["blocks_bytes"] > 0


def test_solve_and_hier_cache_round_trip(runs):
    rap, cached = runs[1:3]
    assert "from_cache" not in rap and cached["from_cache"]
    assert 0 < rap["pcg_iters"] < 20
    assert cached["pcg_iters"] == rap["pcg_iters"]
    assert rap["true_rel_res"] <= 1e-5
    assert cached["true_rel_res"] == rap["true_rel_res"]
    assert rap["supers"] == [2, 2, 2] and rap["fine_layout"] == "flat"
    # device metrics only from a card
    assert "vcycle_ms" not in rap and "peak_hbm_gb" not in rap
    assert "peak_device_bytes_by_phase" not in rap


def test_frugal_mfree_solve(runs):
    """--frugal --mfree: the matrix-free smoother and PCG operator, the
    packed mid operator and the bf16 coarsest inverse solve the same
    problem in about the iterations of the default compile."""
    rap, lean = runs[1], runs[3]
    assert lean["mfree"] and not rap["mfree"]
    assert lean["mid_route"] == "packed" and not lean["mid_resident"]
    assert lean["device_rap"] and lean["levels"] == rap["levels"]
    assert abs(lean["pcg_iters"] - rap["pcg_iters"]) <= 1
    assert lean["true_rel_res"] <= 1e-5


def test_bundle_holds_numpy_and_scipy_only(tmp_path):
    """The pickled solve bundle of a two-level setup names no module of
    the package: it loads with numpy and scipy alone."""
    import pickle
    cache = tmp_path / "b.pkl"
    subprocess.run(
        [sys.executable, "-m", "saamge_tpu_torch.drivers.run_scale_setup"]
        + SMALL + ["--device", "cpu", "--levels", "2", "--hier-cache",
                   str(cache)],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        timeout=300, cwd=REPO, check=True)
    data = cache.read_bytes()
    assert b"saamge" not in data
    bundle = pickle.loads(data)
    assert len(bundle["levels"]) == 1 and bundle["supers"] is None
    assert bundle["out"]["levels"] == [4913, 679]
