"""Cells, configurations, mixes, limits and metric readers are found by
name from BENCHMARK.json, and the file keeps to the format its readers expect."""

import json
import os
import re

import pytest

from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))


def test_every_cell_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["loop"] in ("rhs_stream", "mc_samples")
        assert set(cell.limits["limits"]) == {"res_fine", "res_coarse"}
        assert spec.load_module("entries", cell.config["entry"]).compile
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_per_layer_moves_a_metric_its_cells_report(bench):
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            names = {e["name"] for e in spec.find_cell(w).end_to_end}
            assert m["moves"] in names, (m["name"], w)


def test_reported_without_workloads_key():
    e2e = [{"name": "a"}, {"name": "b", "workloads": ["x"]}]
    assert [m["name"] for m in spec.reported(e2e, "y")] == ["a"]
    per = [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"}]
    assert [m["name"] for m in spec.reported(per, "y", {"a"})] == ["p"]


def test_file_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.load(open(os.path.join(spec.ROOT, c["file"])))[
            "reduced"] == c["reduced"]
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_no_file_imports_jax_or_the_reference_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|saamge_tpu(?!_torch)|bench|"
                     r"chip_smoke|chip_profile)\b", re.M)
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert not bad.search(src), os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "saamge" not in open(os.path.join(ref, f)).read()
