"""The general path: ``api.general_problem`` (generic k-way agglomerates,
the local eigensolves batched on the card) -> ``compile_hierarchy`` ->
``pcg_solve`` by the graph loop."""

from __future__ import annotations

import torch

from perfbench.harness.program import Program


def problem(p: dict, seed: int, device):
    from saamge_tpu_torch import general_problem
    ml, _, _ = general_problem(
        n=p["n"], contrast=p["contrast"], seed=seed,
        elems_per_agg=p["elems_per_agg"], levels=p["levels"],
        theta=p["theta"], device_setup=p["device_setup"], device=device)
    return ml


def compile(p: dict, product, device) -> Program:
    from saamge_tpu_torch import compile_hierarchy, pcg_solve, vcycle_apply
    from saamge_tpu_torch.ops.smoother import smoother_h
    h = compile_hierarchy(product, getattr(torch, p["dtype"]), device=device)
    lv = h.levels[0]
    if not lv.fused:
        raise ValueError("the finest level is not smoothed by the fused "
                         "smoother; the roofline reads that call")

    def solve(b, rel_tol, max_iter):
        x, it, _ = pcg_solve(h, b, rel_tol=rel_tol, max_iter=max_iter)
        return x, it

    def fine_smooth(b):
        A = lv.A
        bh = A.pad(b)
        return smoother_h(A, lv.inv_taus, bh, lv.dinvh, torch.zeros_like(bh),
                          emit_residual=True)

    return Program(h, (p["n"] + 1) ** 3, solve,
                   lambda b: vcycle_apply(h, b), fine_smooth,
                   len(lv.inv_taus), p["dtype"])
