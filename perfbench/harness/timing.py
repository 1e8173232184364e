"""CUDA-event timing on the card (copied from chip_smoke.py ``median_ms``
and chip_profile.py ``replay_ms`` / ``host_gap``, so that later changes to
those scripts do not move the yardstick)."""

from __future__ import annotations


def median_ms(fn, torch, draws: int = 20, calls: int = 10) -> float:
    """Median over ``draws`` CUDA-event draws of the mean time of
    ``calls`` back-to-back calls, after two warm calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(draws):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / calls)
    times.sort()
    return times[len(times) // 2]


def replay_ms(graph, torch, reps: int = 50) -> float:
    """Device time of one replay of a captured graph: ``reps`` replays back
    to back between two CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / reps


def host_gap_us(wall_ms: float, iters: int, prologue_ms: float,
                body_ms: float) -> float:
    """What the host adds to each iteration of a graph-loop solve: the
    untraced wall time less the prologue, over the iterations, less one
    iteration's device time (the flag's read and the next launch)."""
    return ((wall_ms - prologue_ms) / max(iters, 1) - body_ms) * 1e3
