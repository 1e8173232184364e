"""The port's full-capacity configuration (matrix-free fine operator,
packed mid passes, bf16 coarsest inverse) held to the benchmark's plain
float64 reference (perfbench/reference/q1_diffusion.py), and the
counters of its routes, on the CPU at n=16 (4^3-element bricks,
superbricks (2, 2, 2)), c_e = 10^U(-2, 2) from the seed.  Imports no
JAX."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.reference.q1_diffusion import (Q1Operator, block_source,
                                              coefficients, load_vector,
                                              residuals)
from saamge_tpu_torch import (compile_structured, flagship_problem,
                              struct_pcg_solve, struct_vcycle_apply)
from saamge_tpu_torch.ops.mfree import MatrixFreeQ1, mfree_plain_h
from saamge_tpu_torch.utils.logging import TIMERS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BRICK, SUPERS, CONTRAST, SEED = 16, 4, (2, 2, 2), 2.0, 2 ** 31 + 5
BF16 = torch.bfloat16
# f32 storage of c and of x, 8 products a stencil value and 27 taps a
# row, summed in f32: a few units of f32 rounding (6e-8) in norm (1.1e-7
# measured), with room for the cancellation of the taps under other
# fields.  A bf16 field (rounding 4e-3) is off by ~1e-3 and fails it.
OP_TOL = 2e-6


@pytest.fixture(scope="module")
def setup():
    return flagship_problem(n=N, brick=BRICK, contrast=CONTRAST, seed=SEED,
                            supers=SUPERS, mfree=True)


@pytest.fixture(scope="module")
def hierarchies(setup):
    """(capacity, flagship) hierarchies compiled from the same setup."""
    ml, _, geo, supers, fac = setup
    cap = compile_structured(ml, geo, supers, mfree=fac, hbm_frugal=True,
                             ainv_dtype=BF16, device="cpu")
    flag = compile_structured(ml, geo, supers, device="cpu")
    return cap, flag


def _rel(y, ref):
    return float(torch.linalg.vector_norm(y - ref)
                 / torch.linalg.vector_norm(ref))


def test_mfree_operator_matches_the_reference(setup):
    """The f32 PCG operator (``mfree_plain_h`` spmv) against the element
    by element float64 operator, on a random x; the bf16 field fails the
    same tolerance."""
    _, _, geo, _, (em0, c_elem, ess) = setup
    ref_op = Q1Operator(N, coefficients(N, CONTRAST, SEED))
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (N + 1) ** 3))
    ref = ref_op(x)
    errs = {}
    for dt in (torch.float32, BF16):
        op = MatrixFreeQ1.build(c_elem, ess, em0, geo.nodes, dt)
        y = op.unpad(mfree_plain_h("spmv", op, op.pad(x.float())))
        errs[dt] = _rel(y.double(), ref)
    assert errs[torch.float32] <= OP_TOL, errs
    assert errs[BF16] > OP_TOL, errs


def test_capacity_pcg_meets_the_reference(hierarchies):
    """A block load solved to 1e-8 by the capacity hierarchy meets the
    flagship cell's limits against the reference, in at most one
    iteration more or fewer than the stored-operator hierarchy of the
    same setup."""
    with open(os.path.join(REPO, "perfbench", "limits",
                           "flagship.rhs_stream.json")) as f:
        limits = json.load(f)["limits"]
    src = block_source(N, 8, np.random.default_rng(11))
    b = torch.as_tensor(load_vector(N, src))
    op = Q1Operator(N, coefficients(N, CONTRAST, SEED))
    its = []
    for h in hierarchies:
        x, it, _ = struct_pcg_solve(h, b.float(), rel_tol=1e-8,
                                    max_iter=200)
        its.append(it)
        got = residuals(op, b, x.double(), 4)
        assert all(got[k] <= limits[k] for k in limits), got
    assert 0 < its[0] < 200 and abs(its[0] - its[1]) <= 1, its


def test_route_counters_on_the_cpu(hierarchies):
    """On the CPU the matrix-free and packed mid products take their plain
    routes and launch nothing; a V-cycle with the bf16 coarsest inverse
    counts its f32 copy, one with an f32 inverse counts none."""
    cap, flag = hierarchies
    b = torch.ones(cap.n)
    keys = ("mfree.kernel", "mfree.plain", "midmv.kernel", "midmv.plain",
            "coarsest.widened_bytes")
    before = {k: TIMERS.counters.get(k, 0) for k in keys}
    struct_vcycle_apply(cap, b)
    grown = {k: TIMERS.counters.get(k, 0) - before[k] for k in keys}
    assert grown == {"mfree.kernel": 0, "mfree.plain": 2,
                     "midmv.kernel": 0,
                     "midmv.plain": 2 * len(cap.taus1) + 1,
                     "coarsest.widened_bytes": cap.Ainv.numel() * 4}
    assert cap.Ainv.dtype == BF16
    before = TIMERS.counters.get("coarsest.widened_bytes", 0)
    struct_vcycle_apply(flag, b)
    assert TIMERS.counters.get("coarsest.widened_bytes", 0) == before
