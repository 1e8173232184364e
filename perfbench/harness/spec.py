"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``file`` in ``configs``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); its limits are
``perfbench/limits/<cell>.json``; a configuration's ``entry`` is
``perfbench/entries/<entry>.py`` and each metric's reader is
``perfbench/metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    mod_name = f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def problem(self) -> dict:
        """The configuration with the mix's problem keys laid over it (a
        Monte Carlo mix sets its samples' size)."""
        return {**self.config, **self.mix.get("problem", {})}


def reported(metrics: list, cell: str, e2e_names=None) -> list:
    """The metrics a cell reports: those that list it under ``workloads``,
    and those without the key (a per-layer one only where the cell reports
    the end-to-end metric it ``moves``)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m["moves"] in e2e_names:
            out.append(m)
    return out


def find_cell(name: str, root: str = ROOT) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    e2e = reported(spec["end_to_end"], name)
    per_layer = reported(spec["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name, int(w["chips"]), config, mix, limits, e2e, per_layer)
