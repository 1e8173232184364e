"""The port's tracing system (saamge_tpu_torch/utils/logging.PhaseTimers,
the global ``TIMERS``) and the spans and counters that the PCG loop, the
graph table and the compiles add to it (solve/device_pcg.py,
solve/structured.py, solve/compiled.py), on the CPU.

Fixtures: the structured flagship at n=8 (2^3-element bricks,
superbricks (2, 2, 2)) compiled all in f32, and the hexkway general
path at n=8 (64 elements an agglomerate), both with the host setup."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from saamge_tpu_torch import (compile_hierarchy, compile_structured,
                              flagship_problem, general_problem, pcg_solve,
                              struct_pcg_solve, vcycle_apply)
from saamge_tpu_torch.solve.device_pcg import solve_graphs
from saamge_tpu_torch.utils.logging import TIMERS, PhaseTimers

torch.set_num_threads(1)
F32 = torch.float32
PATHS = ("structured", "general")
PCG_RANGES = ("pcg.prologue", "pcg.loop", "pcg.flag_wait", "pcg.launch")


def _grown(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def structured():
    ml, b, geo, supers = flagship_problem(n=8, brick=2, supers=(2, 2, 2))
    before = dict(TIMERS.counts)
    h = compile_structured(ml, geo, supers, smoother_dtype=F32,
                           rp_dtype=F32, mid_dtype=F32, device="cpu")
    return h, torch.as_tensor(b, dtype=F32), _grown(TIMERS.counts, before)


@pytest.fixture(scope="module")
def general():
    ml, _, b = general_problem(n=8, elems_per_agg=64)
    before = dict(TIMERS.counts)
    h = compile_hierarchy(ml, F32, device="cpu")
    return h, torch.as_tensor(b, dtype=F32), _grown(TIMERS.counts, before)


def _path(path, structured, general):
    """(hierarchy, b, the phase calls its compile added, solve)."""
    if path == "structured":
        return (*structured, struct_pcg_solve)
    return (*general, pcg_solve)


def _profiled(fn):
    """The names of the host ranges of a CPU profiler trace of fn()."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


@pytest.mark.parametrize("tracing", [False, True])
def test_phases_are_ranges_only_while_tracing(tracing):
    timers = PhaseTimers()
    timers.tracing = tracing

    def work():
        with timers.phase("t.outer"):
            with timers.phase("t.inner"):
                torch.ones(4).sum()
    names = _profiled(work)
    assert ({"t.outer", "t.inner"} <= set(names)) == tracing
    assert "t.outer" not in names or names.count("t.outer") == 1
    assert timers.counts == {"t.outer": 1, "t.inner": 1}
    assert timers.total("t.outer") >= timers.total("t.inner") > 0
    assert timers.stack == []


def test_counters_add_apart_from_phases_and_reset_clears():
    timers = PhaseTimers()
    timers.count("c.a")
    timers.count("c.a", 4)
    timers.count("c.b", 0)
    with timers.phase("c.a"):
        pass
    assert timers.counters == {"c.a": 5, "c.b": 0}
    assert timers.counts == {"c.a": 1}
    report = timers.report()
    assert "c.b" in report and report.splitlines()[-2].split() == \
        ["c.a", "5"]
    timers.reset()
    assert timers.totals == timers.counts == timers.counters == {}


@pytest.mark.parametrize("path", PATHS)
def test_compile_stages_are_phases(path, structured, general):
    _, _, grown, _ = _path(path, structured, general)
    stages = (("compile.fine", "compile.mid", "compile.coarse")
              if path == "structured" else
              ("compile.levels", "compile.coarsest_inverse"))
    assert grown == dict.fromkeys(("compile", "compile.module") + stages, 1)


@pytest.mark.parametrize("path", PATHS)
def test_eager_solve_counts(path, structured, general):
    """One solve is one call of the phase ``pcg.loop`` and adds exactly
    its returned iterations to ``pcg.iterations``; an eager solve
    captures nothing.  On the general path it also counts its V-cycles'
    block-row products (``blockrow.plain`` on the CPU): the prologue's
    V-cycle and one an iteration, each as many as one V-cycle alone."""
    h, b, _, solve = _path(path, structured, general)
    before = dict(TIMERS.counters)
    if path == "general":
        vcycle_apply(h, b)
    per_cycle = _grown(TIMERS.counters, before).get("blockrow.plain", 0)
    before, calls = dict(TIMERS.counters), dict(TIMERS.counts)
    _, it, _ = solve(h, b, rel_tol=1e-8)
    assert it > 0
    grown = _grown(TIMERS.counters, before)
    assert grown.pop("blockrow.plain", 0) == per_cycle * (it + 1)
    assert per_cycle > 0 if path == "general" else per_cycle == 0
    assert grown == {"pcg.iterations": it}
    assert _grown(TIMERS.counts, calls) == {"pcg.prologue": 1,
                                            "pcg.loop": 1}


@pytest.mark.parametrize("path", PATHS)
def test_traced_solve_ranges_and_result(path, structured, general):
    """With tracing on, a solve's profiler trace holds its prologue and
    loop, a flag wait for each iteration and one more, and a launch for
    each iteration; x, the iterations and (B r, r) are the untraced
    solve's, bit for bit.  On the CPU there are no events to time."""
    h, b, _, solve = _path(path, structured, general)
    plain = solve(h, b, rel_tol=1e-8)
    TIMERS.tracing = True
    try:
        out = []
        names = _profiled(lambda: out.append(solve(h, b, rel_tol=1e-8)))
    finally:
        TIMERS.tracing = False
    x, it, nom = out[0]
    assert it == plain[1] and torch.equal(x, plain[0]) \
        and torch.equal(nom, plain[2])
    assert [names.count(n) for n in PCG_RANGES] == [1, 1, it + 1, it]
    runner = next(v[1] for k, v in solve_graphs(h).items.items()
                  if k[0] == "pcg")
    assert runner.timeline is None
    assert not {n for n in names if n in PCG_RANGES} & set(
        _profiled(lambda: solve(h, b, rel_tol=1e-8)))


def test_graph_table_counts_remade_after_move(structured):
    """A runner is made again, and counted, once the hierarchy's buffers
    have moved (.to), not on a plain second solve; the moved hierarchy
    solves as before (an f32 -> f64 -> f32 round trip is exact)."""
    h, b, _ = structured
    x0, it0, _ = struct_pcg_solve(h, b, rel_tol=1e-8)
    before = TIMERS.counters.get("graph.remade", 0)
    struct_pcg_solve(h, b, rel_tol=1e-8)
    assert TIMERS.counters.get("graph.remade", 0) == before
    h.to(torch.float64).to(F32)
    x1, it1, _ = struct_pcg_solve(h, b, rel_tol=1e-8)
    assert TIMERS.counters["graph.remade"] == before + 1
    assert it1 == it0 and torch.equal(x1, x0)
    struct_pcg_solve(h, b, rel_tol=1e-8)
    assert TIMERS.counters["graph.remade"] == before + 1


def test_device_setup_counts_eig_routes():
    """The device setup (run on the CPU) counts its agglomerates by
    eigensolver route: every brick of both levels once."""
    key = "setup.eig_route."
    before = {k: v for k, v in TIMERS.counters.items() if k.startswith(key)}
    ml, _, _, _ = flagship_problem(n=8, brick=2, supers=(2, 2, 2),
                                   device_setup=True, device="cpu")
    grown = _grown({k: v for k, v in TIMERS.counters.items()
                    if k.startswith(key)}, before)
    routes = [lv.tg_data.interp_data.eig_routes for lv in ml.levels]
    want = {}
    for r in routes:
        for k, v in r.items():
            want[key + k] = want.get(key + k, 0) + v
    assert grown == {k: v for k, v in want.items() if v}
    assert sum(v for k, v in want.items()
               if not k.endswith("host_resolve")) == sum(
        int(np.asarray(lv.rels.nparts)) for lv in ml.levels)
