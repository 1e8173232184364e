"""The control of the comparison, at a size a test run holds: the program
passes the cell's limits, the answers rounded to bfloat16 (the precision
below the float32 PCG that the configurations state) and the state left
unchanged fail them.  On the chip, perfbench/control.py reads the same at
each cell's own size."""

import pytest

from perfbench import control
from perfbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("name", ["flagship.rhs_stream",
                                  "hexkway.rhs_stream",
                                  "flagship.mc_samples"])
def test_control_fails_where_the_program_passes(name):
    cell = tiny_cell(name)
    lim = cell.limits["limits"]
    r = control.readings_of(cell, 2 ** 31 + 23, 0.3, device="cpu")
    assert all(r["program"][k] <= lim[k] for k in lim)
    for bad in ("control", "unchanged", "altered"):
        assert any(r[bad][k] > lim[k] for k in lim), bad
    # the control reads far above the program: rounding to bfloat16
    assert r["control"]["res_fine"] > 100 * r["program"]["res_fine"]
