"""The comparison that decides ``correct``: each kept solution against the
plain float64 operator of ``perfbench/reference/q1_diffusion.py``, built
from the seed by the reference's own code, with nothing taken from the
program.  Numbers (``residuals`` there): ``res_fine`` and ``res_coarse``;
each answer is held to the cell's limits (``perfbench/limits/<cell>.json``),
and a run is correct when no answer fails them and every solve converged."""

from __future__ import annotations

import math

from perfbench.reference.q1_diffusion import (Q1Operator, coefficients,
                                              load_vector, residuals)


def readings(answers, problem: dict, block: int, device, torch) -> list:
    """The numbers of each answer ((coefficient seed, source, x)), in
    order; the operator is built once per coefficient field."""
    n, contrast = problem["n"], problem["contrast"]
    out, op, op_seed = [], None, None
    for coef_seed, source, x in answers:
        if coef_seed != op_seed:
            op = Q1Operator(n, coefficients(n, contrast, coef_seed), device)
            op_seed = coef_seed
        b = torch.as_tensor(load_vector(n, source), device=device)
        xd = x.to(device=device, dtype=torch.float64)
        if xd.shape != b.shape or not bool(torch.isfinite(xd).all()):
            out.append({"res_fine": math.inf, "res_coarse": math.inf})
        else:
            out.append(residuals(op, b, xd, block))
    return out


def judge(numbers: list, limits: dict) -> tuple:
    """(answers that fail a limit, {name: {"value": worst, "limit": l}})."""
    lim = limits["limits"]
    bad = sum(any(r[k] > lim[k] for k in lim) for r in numbers)
    checks = {k: {"value": max((r[k] for r in numbers), default=math.inf),
                  "limit": lim[k]} for k in lim}
    return bad, checks
