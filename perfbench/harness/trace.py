"""A stretch of work under torch.profiler, reduced to the device's busy
time (the union of its kernel intervals, as chip_profile.py's
``device_profile``), its idle gaps named by the benchmark span open on the
host when each began, and its device time by kernel name."""

from __future__ import annotations

import dataclasses
import time

WINDOW = "trace.window"
NAME_CHARS = 160     # a kernel name in the breakdown


@dataclasses.dataclass
class TraceResult:
    busy_s: float        # union of the device intervals
    span_s: float        # first device start to last device end
    window_s: float      # host wall of the traced stretch
    device_ops: list     # [[kernel name, seconds]], most time first
    idle_gaps: list      # [[host span, seconds]], most idle first

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.span_s)


def merge(intervals) -> list:
    """Sorted (start, end) intervals merged where they overlap."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_records(kernels, spans, window, wall_s: float, ignore=(),
                   top: int = 10) -> TraceResult:
    """``kernels``: (name, start us, end us) of the device records;
    ``spans``: (name, start us, end us) of the host spans; ``window``:
    (start us, end us) of the traced stretch on the host.  Device records
    that start outside the window are left out (the profiler's lead-in),
    and so are the device-side copies of the spans' own ranges (the
    profiler's user annotations, named as the spans and in ``ignore``)."""
    ws, we = window
    names = {n for n, _, _ in spans} | set(ignore) | {WINDOW}
    kern = [k for k in kernels if ws <= k[1] <= we and k[0] not in names]
    if not kern:
        raise RuntimeError("the profiler recorded no device work in the "
                           "traced window")
    merged = merge((s, e) for _, s, e in kern)
    busy = sum(e - s for s, e in merged)
    span = merged[-1][1] - merged[0][0]
    by_name = {}
    for name, s, e in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = {}
    inner = sorted(spans, key=lambda r: r[1])
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        owner = "outside spans"
        best = None
        for name, s, e in inner:
            if s <= e0 < e and (best is None or s >= best):
                owner, best = name, s
        gaps[owner] = gaps.get(owner, 0.0) + (s1 - e0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(n[:NAME_CHARS], t) for n, t in ops]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceResult(busy / 1e6, span / 1e6, wall_s,
                       [[n, t / 1e6] for n, t in ops],
                       [[n, t / 1e6] for n, t in idle])


def trace(fn, torch, spans, lead: int = 1000) -> TraceResult:
    """Run ``fn()`` once under the profiler.  The profiler can drop the
    first device records of a window, so the window opens with ``lead``
    small kernels of its own that the reduction leaves out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    spans.tracing = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.tracing = False
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, window = [], [], None
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == cuda:
            kernels.append((ev.name,) + rng)
        elif ev.name == WINDOW:
            window = rng
        elif ev.name in spans.names:
            host.append((ev.name,) + rng)
    if window is None:
        raise RuntimeError("the profiler lost the traced window's range")
    return reduce_records(kernels, host, window, wall, spans.names)
