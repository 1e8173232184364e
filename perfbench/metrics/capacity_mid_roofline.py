"""The least time one packed mid root pass (``mid_pass("root", ...)``)
needs on the card, from the level-1 operator of the setup
(harness/roofline_mfree.py), over its measured time (CUDA events around
the port's pass at the hierarchy's own operands), in %."""

from perfbench.harness.cell import log
from perfbench.harness.roofline import least_time_s
from perfbench.harness.roofline_mfree import mid_pass_work
from perfbench.harness.timing import median_ms


def read(run):
    prog = getattr(run.loop, "prog", None)
    if prog is None or not run.on_card:
        return None
    h, torch = prog.h, run.torch
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2 ** 63)
    x, b = torch.rand((2, h.n_flat), generator=gen, device=run.device)
    tau = h.taus1[0]
    ms = median_ms(lambda: h.mid_pass("root", x, b, tau), torch)
    nbytes, ops = mid_pass_work(prog.mid_nnz, prog.mid_n1, prog.mid_dtype)
    least, bound = least_time_s(nbytes, ops)
    log(f"capacity mid_pass measured_ms={ms!r} least_ms={least * 1e3!r} "
        f"bound={bound} bytes={nbytes} ops={ops} nnz={prog.mid_nnz} "
        f"n1={prog.mid_n1} n_flat={h.n_flat} "
        f"packed_values={h.A1_packed.numel()}")
    return 100.0 * least / (ms / 1e3)
