"""Agglomerates the cell's one setup re-solves exactly on the host after
the batched filtered eigensolver (the program's counter
``setup.eig_route.host_resolve``, utils/logging.TIMERS)."""

from perfbench.harness.cell import log


def read(run):
    from saamge_tpu_torch.utils.logging import TIMERS
    counters = getattr(TIMERS, "counters", {})
    key = "setup.eig_route.host_resolve"
    if key not in counters:
        return None
    routes = {k: v for k, v in counters.items()
              if k.startswith("setup.eig_route.")}
    log(f"setup routes={routes} resolve_s="
        f"{TIMERS.total('setup.local_eigensolves.resolve')!r}")
    return counters[key]
