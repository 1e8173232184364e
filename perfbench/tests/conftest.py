"""CPU tests of the benchmark harness.  ``tiny_cell`` is a cell of
BENCHMARK.json cut to a size the CPU runs in seconds, with the port's plain
kernels."""

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"flagship": {"n": 16, "brick": 4, "super_bricks": [2, 2, 2]},
        "hexkway": {"n": 16, "elems_per_agg": 64}}


def tiny_cell(name: str):
    from perfbench.harness import spec
    c = spec.find_cell(name)
    mix = dict(c.mix)
    if "problem" in mix:
        mix["problem"] = {"n": 16, "super_bricks": [2, 2, 2]}
    return dataclasses.replace(
        c, config={**c.config, **TINY[c.config["name"]]}, mix=mix,
        limits={**c.limits, "check_block": 4})
