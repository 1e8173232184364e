"""The structured flagship path: ``api.flagship_problem`` (host setup, the
local eigensolves on the card) -> ``compile_structured`` ->
``struct_pcg_solve`` by the graph loop."""

from __future__ import annotations

import torch

from perfbench.harness.program import Program


def problem(p: dict, seed: int, device):
    from saamge_tpu_torch import flagship_problem
    ml, _, geo, supers = flagship_problem(
        n=p["n"], brick=p["brick"], contrast=p["contrast"], seed=seed,
        supers=tuple(p["super_bricks"]), theta=p["theta"],
        device_setup=p["device_setup"], device=device)
    return ml, geo, supers


def compile(p: dict, product, device) -> Program:
    from saamge_tpu_torch import (compile_structured, struct_pcg_solve,
                                  struct_vcycle_apply)
    ml, geo, supers = product
    dt = {k: getattr(torch, p[k]) for k in
          ("smoother_dtype", "rp_dtype", "mid_dtype")}
    h = compile_structured(ml, geo, supers, device=device, **dt)

    def solve(b, rel_tol, max_iter):
        x, it, _ = struct_pcg_solve(h, b, rel_tol=rel_tol,
                                    max_iter=max_iter)
        return x, it

    def fine_smooth(b):
        A = h.A0s
        bh = A.pad(b)
        return h._smooth_h(A, bh, torch.zeros_like(bh), emit_res=True)

    return Program(h, (p["n"] + 1) ** 3, solve,
                   lambda b: struct_vcycle_apply(h, b), fine_smooth,
                   len(h.taus0), p["smoother_dtype"])
