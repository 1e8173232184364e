"""The full-capacity structured path: ``api.flagship_problem`` with the
matrix-free factors (host setup, the local eigensolves on the card) ->
``compile_structured`` with a matrix-free fine operator, packed mid passes
only (``hbm_frugal``) and a bf16 coarsest inverse -> ``struct_pcg_solve``
by the graph loop."""

import dataclasses

import torch

from perfbench.harness.program import Program


@dataclasses.dataclass
class CapacityProgram(Program):
    mid_nnz: int = 0            # the level-1 operator's nonzeros (setup CSR)
    mid_n1: int = 0             # and its dofs
    mid_dtype: str = "float32"  # stored dtype of the packed mid operator


def problem(p: dict, seed: int, device):
    from saamge_tpu_torch import flagship_problem
    ml, _, geo, supers, fac = flagship_problem(
        n=p["n"], brick=p["brick"], contrast=p["contrast"], seed=seed,
        supers=tuple(p["super_bricks"]), theta=p["theta"], mfree=p["mfree"],
        device_setup=p["device_setup"], device=device)
    return ml, geo, supers, fac


def compile(p: dict, product, device) -> Program:
    from saamge_tpu_torch import (compile_structured, struct_pcg_solve,
                                  struct_vcycle_apply)
    ml, geo, supers, fac = product
    dt = {k: getattr(torch, p[k]) for k in
          ("smoother_dtype", "rp_dtype", "mid_dtype", "ainv_dtype")}
    h = compile_structured(ml, geo, supers, device=device, mfree=fac,
                           hbm_frugal=p["hbm_frugal"], **dt)

    def solve(b, rel_tol, max_iter):
        x, it, _ = struct_pcg_solve(h, b, rel_tol=rel_tol,
                                    max_iter=max_iter)
        return x, it

    def fine_smooth(b):
        A = h.A0s
        bh = A.pad(b)
        return h._smooth_h(A, bh, torch.zeros_like(bh), emit_res=True)

    return CapacityProgram(h, (p["n"] + 1) ** 3, solve,
                           lambda b: struct_vcycle_apply(h, b), fine_smooth,
                           len(h.taus0), p["smoother_dtype"],
                           mid_nnz=int(ml.levels[1].A.nnz),
                           mid_n1=int(ml.levels[1].A.shape[0]),
                           mid_dtype=p["mid_dtype"])
