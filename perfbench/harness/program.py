"""The port's compiled solver as a cell drives it: what an entry module
(``perfbench/entries/<entry>.py``) hands back."""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class Program:
    h: object                  # the compiled hierarchy
    ndof: int
    solve: Callable            # (b, rel_tol, max_iter) -> (x, iterations)
    vcycle: Callable           # b -> one preconditioner application
    fine_smooth: Callable      # b -> one fine smoothing chain (+ residual)
    fine_roots: int            # polynomial roots of that chain
    fine_dtype: str            # stored dtype of the operator it reads

    def graphs(self, b):
        """(prologue, body) CUDA graphs of the solve loop that ``b``'s
        solves replay, or None before the first solve on the card."""
        from saamge_tpu_torch.solve.device_pcg import solve_graphs
        hit = solve_graphs(self.h).items.get(
            ("pcg", b.dtype, b.device, False))
        return None if hit is None else hit[1].graphs


def eig_seconds() -> float:
    """Seconds the setup's timers (utils/logging.TIMERS) have spent in the
    local eigensolvers: the uniform-brick device pipeline and the batched
    eigensolver."""
    from saamge_tpu_torch.utils.logging import TIMERS
    return (TIMERS.total("setup.device_pipeline")
            + TIMERS.total("setup.local_eigensolves"))
