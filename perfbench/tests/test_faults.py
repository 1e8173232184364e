"""A run with the timed path broken underneath (the harness's look for a
card skipped, the rest of the run driven on the CPU) comes out not
correct, once for each fault these cells can have: the solve returns its
state unchanged; the answer is altered where it is produced; the solve
stops without converging.  (No cell has a batch to halve or an exchange
between chips to leave out.)"""

import dataclasses
import time

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import spec
from perfbench.tests.conftest import tiny_cell


def unchanged(solve):
    def broken(b, rel_tol, max_iter):
        x, it = solve(b, rel_tol, max_iter)
        return x.new_zeros(x.shape), it
    return broken


def altered(solve):
    def broken(b, rel_tol, max_iter):
        x, it = solve(b, rel_tol, max_iter)
        x = x.clone()
        x[::64] *= 1.01
        return x, it
    return broken


def not_converged(solve):
    def broken(b, rel_tol, max_iter):
        x, _ = solve(b, rel_tol, max_iter)
        return x, max_iter
    return broken


@pytest.mark.parametrize("fault", [unchanged, altered, not_converged])
@pytest.mark.parametrize("name", ["flagship.rhs_stream",
                                  "hexkway.rhs_stream",
                                  "flagship.mc_samples"])
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    real = spec.load_module

    def load_module(kind, mod):
        m = real(kind, mod)
        if kind != "entries":
            return m

        class Broken:
            problem = staticmethod(m.problem)

            @staticmethod
            def compile(p, product, device):
                prog = m.compile(p, product, device)
                return dataclasses.replace(prog, solve=fault(prog.solve))
        return Broken

    monkeypatch.setattr(spec, "load_module", load_module)
    result = cells.run_cell(cell, 2 ** 31 + 29, 0.3, False,
                            time.perf_counter(), device="cpu")
    assert result["correct"] is False
    assert result["failed"] >= 1
