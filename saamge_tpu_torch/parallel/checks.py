"""The production-regime sharded parity check, port of
saamge_tpu/parallel/checks.py.

The flagship configuration (the resident mid chain, the window tent
kernels, bf16 twins, the superbrick coarsest; the single-card cycle
smooths with the wavefront sweep) sharded over a mesh must reproduce
the single-card preconditioner: a V-cycle within 1e-3 of the
single-card flagship's (the sharded path smooths root by root and rounds
the mid x through bf16), and PCG iterations equal to the one-shard
sharded solve's (the pmltest serial / parallel invariant, reference
amg/CMakeLists.txt:198-203).  The JAX precondition ``nb % P == 0 or P %
nb == 0`` is not copied: ``shard_structured`` raises unless P divides
the brick layers."""

from __future__ import annotations

import numpy as np
import torch


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"production-regime sharded check: {what}")


def production_regime_sharded_check(mesh, ns: int = 48, brick: int = 6,
                                    supers=(2, 2, 2), seed: int = 7,
                                    max_iter: int = 80,
                                    device_setup: bool = False) -> dict:
    """Build the high-contrast 3-level flagship problem at (ns+1)^3 dofs
    (``api.flagship_problem``; ``device_setup`` solves its local
    eigenproblems on the mesh's first device), compile the flagship
    configuration there, require each of its routes, shard it over
    ``mesh`` and require parity.  Returns the diagnostics."""
    from saamge_tpu_torch.api import flagship_problem
    from saamge_tpu_torch.ops.sparse import DIA
    from saamge_tpu_torch.parallel.mesh import ShardMesh
    from saamge_tpu_torch.parallel.structured_sharded import (
        gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
        mid_bytes_per_device, scatter_fine, shard_structured)
    from saamge_tpu_torch.solve.structured import (compile_structured,
                                                   struct_vcycle_apply)

    dev = mesh.devices[0]
    ml, b, geo, supers = flagship_problem(
        n=ns, brick=brick, seed=seed, supers=supers,
        device_setup=device_setup, device=dev)
    A = ml.levels[0].A
    h = compile_structured(ml, geo, supers, device=dev)
    del ml
    _require(h.mid_route == "resident", f"mid route {h.mid_route}, not "
             "the resident chain")
    _require(not h.contract, "the tent runs box contractions, not the "
             "window kernels")
    _require(isinstance(h.A0s, DIA), "the smoother twin is matrix-free, "
             "not the wavefront sweep's diagonals")
    bt = torch.as_tensor(b, dtype=torch.float32)
    y_ref = struct_vcycle_apply(h, bt.to(dev)).cpu()

    hs = shard_structured(h, mesh)
    _require(hs.mid is None, "the mid level is replicated, not "
             "distributed")
    _require(hs.st.supers is not None, "the superbrick coarsest is not "
             "sharded")
    acct = mid_bytes_per_device(hs)
    total_mid = sum(t.numel() * t.element_size()
                    for t in (h.A1_blocks, h.dinv1, h.Rst1))
    P = mesh.size
    _require(acct["sharded"] <= total_mid // P + total_mid // 8,
             f"sharded mid bytes {acct} against {total_mid} in all")
    _require(acct["replicated"] <= h.Ainv.numel() * h.Ainv.element_size()
             + (1 << 20), f"replicated mid bytes {acct}")
    bsh = scatter_fine(hs, bt)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh)).cpu()
    wf_diff = float((y - y_ref).abs().max() / y_ref.abs().max())
    _require(wf_diff <= 1e-3, f"sharded V-cycle {wf_diff:.3e} off the "
             "single-card flagship's")

    hs1 = shard_structured(h, ShardMesh([dev]))
    _, it_ref = make_struct_sharded_pcg(hs1, max_iter=max_iter)(
        scatter_fine(hs1, bt))
    del hs1
    x, it = make_struct_sharded_pcg(hs, max_iter=max_iter)(bsh)
    _require(it == it_ref, f"{it} PCG iterations on {P} shards, {it_ref} "
             "on one")
    xh = gather_fine(hs, x).double().cpu().numpy()
    rel = float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))
    _require(rel < 1e-4, f"true relative residual {rel:.3e}")
    return {"n": A.shape[0], "shards": P, "wf_diff": wf_diff, "iters": it,
            "iters_ref": it_ref, "rel_res": rel,
            "mid_distributed": hs.mid is None, "mid_bytes": acct,
            "mid_bytes_total": total_mid}
