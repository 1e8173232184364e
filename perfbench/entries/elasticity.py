"""3D linear elasticity on the general path: ``api.elasticity_problem``
(generic k-way agglomerates, the rigid-body modes and the local
eigensolves batched on the card) -> ``compile_hierarchy`` (the finest
level in the node-block format) -> ``pcg_solve`` by the graph loop."""

from __future__ import annotations

import torch

from perfbench.harness.program import Program

# the configuration's ``clamp`` -> the boundary attributes clamped
CLAMP_ATTRS = {"x0": (1,)}


def problem(p: dict, seed: int, device):
    from saamge_tpu_torch import elasticity_problem
    ml, _, _ = elasticity_problem(
        n=p["n"], contrast=p["contrast"], seed=seed,
        first_elems_per_agg=p["first_elems_per_agg"],
        elems_per_agg=p["elems_per_agg"], levels=p["levels"],
        theta=p["theta"], clamp_attrs=CLAMP_ATTRS[p["clamp"]],
        device_setup=p["device_setup"], device=device)
    return ml


def compile(p: dict, product, device) -> Program:
    from saamge_tpu_torch import compile_hierarchy, pcg_solve, vcycle_apply
    h = compile_hierarchy(product, getattr(torch, p["dtype"]), device=device)
    lv = h.levels[0]
    if not lv.blocked:
        raise ValueError("the finest level is not in the node-block format "
                         "smoothed by its chain; the roofline reads that "
                         "call")

    def solve(b, rel_tol, max_iter):
        x, it, _ = pcg_solve(h, b, rel_tol=rel_tol, max_iter=max_iter)
        return x, it

    def fine_smooth(b):
        bh = lv.A.pad(b)
        return lv.chain_h(bh, torch.zeros_like(bh), emit_residual=True)

    return Program(h, 3 * (p["n"] + 1) ** 3, solve,
                   lambda b: vcycle_apply(h, b), fine_smooth,
                   len(lv.inv_taus), p["dtype"])
