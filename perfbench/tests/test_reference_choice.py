"""The harness judges and feeds a cell by the reference module that its
configuration names (``perfbench/reference/<reference>.py``): a planted
module decides ``correct``; the Q1 module gives the readings, ring loads
and Monte Carlo load that the harness computed from its functions directly
before it read the configuration's reference; a configuration without its
reference, and a program of another size than the reference's, fail
loudly."""

import json
import math
import os
import time
import types

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.harness import spec
from perfbench.harness.correct import readings
from perfbench.harness.program import Program
from perfbench.harness.traffic import RHS, derive
from perfbench.reference import q1_diffusion as q
from perfbench.tests.conftest import tiny_cell

SEED = 2 ** 33 + 7


def doubled(real):
    """The Q1 reference with its coefficients doubled."""
    mod = types.ModuleType("doubled_q1")
    mod.__dict__.update(real.__dict__)

    def operator(problem, coef_seed, device):
        n = problem["n"]
        c = real.coefficients(n, problem["contrast"], coef_seed)
        return real.Q1Operator(n, 2.0 * c, device)
    mod.operator = operator
    return mod


@pytest.mark.parametrize("planted", [False, True])
def test_the_named_reference_decides_correct(planted, monkeypatch):
    cell = tiny_cell("flagship.rhs_stream")
    real, loaded = spec.load_module, []

    def load_module(kind, name):
        m = real(kind, name)
        if kind == "reference":
            loaded.append(name)
            return doubled(m) if planted else m
        return m

    monkeypatch.setattr(spec, "load_module", load_module)
    result = cells.run_cell(cell, SEED, 0.3, False, time.perf_counter(),
                            device="cpu")
    assert loaded == [cell.config["reference"]]
    assert result["correct"] is (not planted)
    if planted:
        # b - 2 A x with A x = b: every answer reads ~1
        assert result["checks"]["res_fine"]["value"] > 0.5


@pytest.mark.parametrize("name", ["flagship.rhs_stream",
                                  "hexkway.rhs_stream"])
def test_readings_as_the_direct_computation(name):
    """The readings of a tiny run's kept answers, and of an answer of the
    wrong length, equal the Q1 operator and residuals computed directly
    from n, the contrast and the coefficient seed."""
    cell = tiny_cell(name)
    run = cells.Run(cell, SEED, "cpu", torch)
    run.loop.setup()
    run.loop.window(0.3)
    answers = run.loop.answers()
    s, f, x = answers[0]
    answers.append((s, f, x[:-1]))
    got = readings(run.ref, answers, run.problem, cell.limits, "cpu", torch)
    n, contrast = run.problem["n"], run.problem["contrast"]
    block = cell.limits["check_block"]
    want = []
    for coef_seed, source, x in answers[:-1]:
        op = q.Q1Operator(n, q.coefficients(n, contrast, coef_seed), "cpu")
        b = torch.as_tensor(q.load_vector(n, source))
        want.append(q.residuals(op, b, x.to(dtype=torch.float64), block))
    want.append({"res_fine": math.inf, "res_coarse": math.inf})
    assert len(got) >= 2 and got == want


def stub_entry(extra_dofs: int):
    """An entry that sets nothing up and returns x = 0 in one iteration,
    for a program of the reference's dofs plus ``extra_dofs``."""
    def problem(p, seed, device):
        return None

    def compile(p, product, device):
        def solve(b, rel_tol, max_iter):
            return torch.zeros_like(b), 1
        return Program(None, (p["n"] + 1) ** 3 + extra_dofs, solve, None,
                       None, 0, "float32")
    return types.SimpleNamespace(problem=problem, compile=compile)


def stubbed(monkeypatch, extra_dofs):
    real = spec.load_module

    def load_module(kind, name):
        return stub_entry(extra_dofs) if kind == "entries" \
            else real(kind, name)
    monkeypatch.setattr(spec, "load_module", load_module)


@pytest.mark.parametrize("name", ["flagship.rhs_stream",
                                  "hexkway.rhs_stream",
                                  "flagship.mc_samples"])
def test_loads_as_the_direct_computation(name, monkeypatch):
    """For one seed, the ring's sources and loads, and the Monte Carlo
    source and load, equal the Q1 functions called with n, as the harness
    called them before it read the configuration's reference."""
    stubbed(monkeypatch, 0)
    cell = tiny_cell(name)
    run = cells.Run(cell, SEED, "cpu", torch)
    run.loop.setup()
    n = run.problem["n"]
    if cell.mix["loop"] == "rhs_stream":
        rng = np.random.default_rng(derive(SEED, RHS))
        sources = [q.block_source(n, cell.mix["source_block"], rng)
                   for _ in range(cell.mix["ring"])]
        ring = torch.stack([torch.as_tensor(q.load_vector(n, f),
                                            dtype=torch.float32)
                            for f in sources])
        assert len(run.loop.sources) == len(sources)
        assert all(np.array_equal(a, b)
                   for a, b in zip(run.loop.sources, sources))
        assert torch.equal(run.loop.ring, ring)
    else:
        source = np.ones(n ** 3)
        assert np.array_equal(run.loop.source, source)
        assert torch.equal(run.loop.b, torch.as_tensor(
            q.load_vector(n, source), dtype=torch.float32))


@pytest.mark.parametrize("name", ["flagship.rhs_stream",
                                  "flagship.mc_samples"])
def test_setup_raises_for_a_program_of_other_dofs(name, monkeypatch):
    stubbed(monkeypatch, 3)
    cell = tiny_cell(name)
    run = cells.Run(cell, SEED, "cpu", torch)
    want = (run.problem["n"] + 1) ** 3
    with pytest.raises(ValueError, match=f"{want + 3} dofs.* {want}$"):
        run.loop.setup()


@pytest.mark.parametrize("reference", [None, "nope"])
def test_find_cell_raises_without_its_reference(reference, tmp_path):
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    cfg = next(c for c in bench["configs"] if c["name"] == "flagship")
    config = spec.load_json(os.path.join(spec.ROOT, cfg["file"]))
    del config["reference"]
    if reference is not None:
        config["reference"] = reference
    (tmp_path / "flagship.json").write_text(json.dumps(config))
    cfg["file"] = "flagship.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError if reference is None
                       else FileNotFoundError):
        spec.find_cell("flagship.rhs_stream", root=str(tmp_path))


def test_the_harness_names_no_reference_module():
    """The harness and the control reach a reference only through the
    name that a configuration gives."""
    harness = os.path.join(spec.BENCH_DIR, "harness")
    files = [os.path.join(harness, f) for f in os.listdir(harness)
             if f.endswith(".py")]
    files.append(os.path.join(spec.BENCH_DIR, "control.py"))
    for path in files:
        with open(path) as f:
            assert "q1_diffusion" not in f.read(), path
