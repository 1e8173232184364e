"""The comparison that decides ``correct``: each kept solution against the
plain float64 operator of the configuration's reference
(``perfbench/reference/<reference>.py``, the module that the
configuration's ``reference`` names, loaded once a run as ``Run.ref``),
built from the seed by the reference's own code, with nothing taken from
the program.  The numbers are those of the reference's ``residuals``, one
for each key of the cell's limits (``perfbench/limits/<cell>.json``); a run
is correct when no answer fails them and every solve converged."""

from __future__ import annotations

import math


def readings(ref, answers, problem: dict, limits: dict, device,
             torch) -> list:
    """The numbers of each answer ((coefficient seed, source, x)), in
    order, by the reference module ``ref`` on blocks of the cell's
    ``check_block``; the operator is built once per coefficient field.  An
    answer of the wrong length or not finite reads infinite."""
    block = limits["check_block"]
    out, op, op_seed = [], None, None
    for coef_seed, source, x in answers:
        if coef_seed != op_seed:
            op = ref.operator(problem, coef_seed, device)
            op_seed = coef_seed
        b = torch.as_tensor(ref.load_vector(problem, source), device=device)
        xd = x.to(device=device, dtype=torch.float64)
        if xd.shape != b.shape or not bool(torch.isfinite(xd).all()):
            out.append(dict.fromkeys(limits["limits"], math.inf))
        else:
            out.append(ref.residuals(op, b, xd, block))
    return out


def judge(numbers: list, limits: dict) -> tuple:
    """(answers that fail a limit, {name: {"value": worst, "limit": l}})."""
    lim = limits["limits"]
    bad = sum(any(r[k] > lim[k] for k in lim) for r in numbers)
    checks = {k: {"value": max((r[k] for r in numbers), default=math.inf),
                  "limit": lim[k]} for k in lim}
    return bad, checks
