"""The program's own spans and events over the mix's traced stretch of
solves: utils/logging.TIMERS with ``tracing`` on, whose phases are then
profiler ranges (``pcg.prologue``, ``pcg.loop``, and a ``pcg.flag_wait``
and a ``pcg.launch`` range an iteration), and the CUDA events that the
PCG runner records around each graph launch (solve/device_pcg.py,
``PCGRunner.timeline``).  The stretch runs twice:

(a) without the profiler: each solve's launches as (name, start, end) on
    the device's own clock, from the runner's events; CUPTI touches none
    of them.
(b) under torch.profiler: each graph replay's kernels, grouped by the
    correlation id of its ``cudaGraphLaunch``, and each idle gap between
    two replays split among the program's ranges open on the host while
    it lasted (the innermost at each moment).

A program without these spans and events (one older than them) gives
None, as does a mix that is not a stream of solves."""

from __future__ import annotations

import dataclasses
import statistics
import time

from perfbench.harness.timing import replay_ms
from perfbench.harness.trace import merge

RANGES = ("pcg.prologue", "pcg.loop", "pcg.flag_wait", "pcg.launch")
HOST = ("pcg.flag_wait", "pcg.launch")     # host seconds read in (a)
LAUNCH = "cudaGraphLaunch"
OUTSIDE = "outside"
LEAD = 1000          # small kernels that open a profiler window
TRIES = 3            # profiler windows taken until every replay has records


@dataclasses.dataclass
class Replay:
    name: str          # "prologue" or "body"
    kernels: int       # device records of its correlation id
    busy_ns: float     # the union of their intervals
    start_ns: float    # the first one's start
    end_ns: float      # the last one's end


def group_replays(device, launches, ranges) -> list:
    """Solves of (b), each a list of Replays in launch order.  ``device``:
    (correlation id, start ns, end ns) of the device records;
    ``launches``: (correlation id, start ns) of the host's graph launches;
    ``ranges``: (name, start ns, end ns) of the program's ranges.  A launch
    inside a ``pcg.prologue`` range opens a solve; launches before the
    first such one are left out, and so are replays with no records."""
    by_corr = {}
    for corr, s, e in device:
        by_corr.setdefault(corr, []).append((s, e))
    prologues = [(s, e) for name, s, e in ranges if name == "pcg.prologue"]
    solves = []
    for corr, t in sorted(launches, key=lambda x: x[1]):
        first = any(s <= t <= e for s, e in prologues)
        if first:
            solves.append([])
        if not solves or corr not in by_corr:
            continue
        merged = merge(by_corr[corr])
        solves[-1].append(Replay(
            "prologue" if first else "body", len(by_corr[corr]),
            sum(e - s for s, e in merged), merged[0][0], merged[-1][1]))
    return solves


def innermost(ranges, t: float) -> str:
    """The name of the innermost range open at ``t`` (the latest begun)."""
    best = None
    for name, s, e in ranges:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return OUTSIDE if best is None else best[0]


def split_interval(lo: float, hi: float, ranges) -> dict:
    """{range name: ns} of [lo, hi], each moment to its innermost range."""
    cuts = sorted({lo, hi} | {x for _, s, e in ranges for x in (s, e)
                              if lo < x < hi})
    out = {}
    for a, b in zip(cuts, cuts[1:]):
        name = innermost(ranges, 0.5 * (a + b))
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def split_idle(solves, ranges) -> tuple:
    """(idle ns inside the replays, {range name: idle ns between two
    replays of one solve})."""
    inside, between = 0.0, {}
    for replays in solves:
        for r in replays:
            inside += (r.end_ns - r.start_ns) - r.busy_ns
        for r, q in zip(replays, replays[1:]):
            for name, ns in split_interval(r.end_ns, q.start_ns,
                                           ranges).items():
                between[name] = between.get(name, 0.0) + ns
    return inside, between


def launch_gaps_us(timeline) -> list:
    """(a): from each launch's end event to the next one's start event,
    within one solve (``timeline``: (name, start ms, end ms))."""
    return [(q[1] - r[2]) * 1e3 for r, q in zip(timeline, timeline[1:])]


def graph_idle_pct(body_busy_ns, body_ms) -> float:
    """100 (1 - median busy of a body replay, from (b) / median length of
    a body replay between its events, from (a))."""
    busy_ms = statistics.median(body_busy_ns) / 1e6
    return 100.0 * (1.0 - busy_ms / statistics.median(body_ms))


@dataclasses.dataclass
class ProgramTrace:
    timelines: list    # (a): per solve, (name, start ms, end ms)
    solves: list       # (b): per solve, Replays; paired with timelines
    inside_ns: float   # (b): idle inside the replays
    between: dict      # (b): idle between replays, by range, ns
    busy_ns: float     # (b): union of every device record in the solves

    @property
    def launch_gap_us(self) -> float:
        return statistics.median(g for t in self.timelines
                                 for g in launch_gaps_us(t))

    @property
    def graph_idle_pct(self) -> float:
        return graph_idle_pct(
            [r.busy_ns for s in self.solves for r in s if r.name == "body"],
            [z - a for t in self.timelines for n, a, z in t if n == "body"])

    def span_a_ms(self) -> float:
        return sum(t[-1][2] - t[0][1] for t in self.timelines)

    def span_b_ms(self) -> float:
        return sum(s[-1].end_ns - s[0].start_ns for s in self.solves) / 1e6


def _runner(prog):
    from saamge_tpu_torch.solve.device_pcg import solve_graphs
    for key, (_, runner) in solve_graphs(prog.h).items.items():
        if key[0] == "pcg":
            return runner
    return None


def _profiled(stretch, torch) -> tuple:
    """(b): stretch() under the profiler; (solves, ranges, device)."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD):
            pad.add_(1.0)
        torch.cuda.synchronize()
        stretch()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device, launches, ranges = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        rec = (s, s + ev.duration_ns())
        if ev.device_type() == cuda:
            # the device-side copies of the host ranges are no work
            if name not in RANGES and not getattr(
                    ev, "is_user_annotation", lambda: False)():
                device.append((ev.correlation_id(),) + rec)
        elif name in RANGES:
            ranges.append((name,) + rec)
        elif name.startswith(LAUNCH):
            launches.append((ev.correlation_id(), s))
    return group_replays(device, launches, ranges), ranges, device


def kernel_counts(solves) -> dict:
    """{"<replay name>:<kernels>": replays} over ``solves``."""
    counts = {}
    for s in solves:
        for r in s:
            key = f"{r.name}:{r.kernels}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def _paired(solves, timelines) -> list:
    """Indices of the solves whose (b) replays match (a)'s launches, each
    replay with the kernel count most replays of its name have: a graph
    runs all its nodes, so a replay with fewer lost records to the
    profiler."""
    usual = {name: statistics.mode(r.kernels for s in solves for r in s
                                   if r.name == name)
             for name in {r.name for s in solves for r in s}}
    return [k for k, (s, t) in enumerate(zip(solves, timelines))
            if [r.name for r in s] == [n for n, _, _ in t]
            and all(r.kernels == usual[r.name] for r in s)]


def _make(run):
    loop = run.loop
    prog = getattr(loop, "prog", None)
    if run.mix["loop"] != "rhs_stream" or prog is None or not run.on_card:
        return None
    from saamge_tpu_torch.utils.logging import TIMERS
    runner = _runner(prog)
    if not (hasattr(TIMERS, "counters") and hasattr(runner, "timeline_ms")):
        return None
    torch, n, ring = run.torch, run.mix["trace_requests"], run.mix["ring"]

    def stretch():
        for k in range(n):
            loop.solve(loop.ring[k % ring])

    timelines, host_ms, returned = [], [], 0
    TIMERS.tracing = True
    try:
        before = {k: TIMERS.total(k) for k in HOST}
        counted = TIMERS.counters.get("pcg.iterations", 0)
        for k in range(n):
            t0 = time.perf_counter()
            returned += loop.solve(loop.ring[k % ring])[1]
            timelines.append(runner.timeline_ms())
            host_ms.append((time.perf_counter() - t0) * 1e3)
        host = {k: TIMERS.total(k) - before[k] for k in HOST}
        iters = TIMERS.counters.get("pcg.iterations", 0) - counted
        # a body replayed back to back: the launch lead hides behind
        # the replay before it (the state is loaded anew by each solve)
        back_to_back_ms = replay_ms(runner.graphs[1], torch)
        best, tried = None, []
        for windows in range(1, TRIES + 1):
            got = _profiled(stretch, torch)
            keep = _paired(got[0], timelines)
            tried.append((kernel_counts(got[0]), len(keep)))
            if best is None or len(keep) > len(best[1]):
                best = (got, keep)
            if len(keep) == n:
                break
    finally:
        TIMERS.tracing = False
    (solves, ranges, device), keep = best
    if not keep:
        raise RuntimeError(
            "the profiler's replays match no solve's events: (b) "
            f"{[[r.name for r in s][:3] for s in solves][:3]}, (a) "
            f"{[[m for m, _, _ in t][:3] for t in timelines][:3]}")
    solves = [solves[k] for k in keep]
    inside, between = split_idle(solves, ranges)
    busy = 0.0
    for s in solves:
        lo, hi = s[0].start_ns, s[-1].end_ns
        busy += sum(e - b for b, e in merge(
            (b, e) for _, b, e in device if lo <= b < hi))
    pt = ProgramTrace([timelines[k] for k in keep], solves, inside, between,
                      busy)
    _log(pt, n, tried, {
        "pcg.iterations": iters, "returned": returned,
        "launched": sum(len(t) - 1 for t in timelines),
        "host_ms_tracing_on": statistics.median(host_ms),
        "host_ms_tracing_off": statistics.median(r["host_ms"]
                                                 for r in run.records),
        **{f"host_us.{k}": v / iters * 1e6 for k, v in host.items()},
        "body_back_to_back_ms": back_to_back_ms, "profiler_windows": windows})
    return pt


def program_trace(run):
    """The cell's ProgramTrace (or None), made once and kept on the run."""
    if not hasattr(run, "_program_trace"):
        run._program_trace = _make(run)
    return run._program_trace


def _log(pt: ProgramTrace, n: int, tried: list, seen: dict) -> None:
    """What the readers derive and do not report, to standard error:
    each profiler window's kernels a replay, before any solve is left
    out, and the solves kept; ``seen``: the iterations of (a) as the
    counter ``pcg.iterations`` adds them, as the solves return them and
    as the body launches count them, (a)'s host times a solve (tracing
    on, and the window's with it off) and an iteration, and a body
    replayed back to back."""
    from perfbench.harness.cell import log
    per = len(pt.solves)
    span_a, span_b = pt.span_a_ms(), pt.span_b_ms()
    gaps = sorted(g for t in pt.timelines for g in launch_gaps_us(t))
    body = statistics.median(z - a for t in pt.timelines for m, a, z in t
                             if m == "body")
    busy = statistics.median(r.busy_ns for s in pt.solves for r in s
                             if r.name == "body") / 1e6
    span = statistics.median(r.end_ns - r.start_ns for s in pt.solves
                             for r in s if r.name == "body") / 1e6
    b2b = seen.pop("body_back_to_back_ms")
    its = [seen.pop(k) for k in ("pcg.iterations", "returned", "launched")]
    for line in (
            *(f"window {k + 1}: replay_kernels={c} (every replay) "
              f"solves kept={m}/{n}" for k, (c, m) in enumerate(tried)),
            f"solves={per}/{n} replay_kernels={kernel_counts(pt.solves)}",
            "idle between launches (b), us a solve: " + " ".join(
                f"{k}={v / 1e3 / per!r}" for k, v in
                sorted(pt.between.items(), key=lambda kv: -kv[1]))
            + f" inside replays={pt.inside_ns / 1e3 / per!r}",
            f"untraced_idle_pct={100 * (1 - pt.busy_ns / 1e6 / span_a)!r} "
            f"(busy of (b) over the event span of (a)) profiled_idle_pct="
            f"{100 * (1 - pt.busy_ns / 1e6 / span_b)!r} profiler_stretch="
            f"{span_b / span_a!r}; a solve: span_a_ms={span_a / per!r} "
            f"span_b_ms={span_b / per!r} busy_ms={pt.busy_ns / 1e6 / per!r}",
            f"launch_gap_us min={gaps[0]!r} median="
            f"{statistics.median(gaps)!r} max={gaps[-1]!r} "
            f"graph_idle_pct={pt.graph_idle_pct!r}",
            f"body ms: between its events (a)={body!r} back to back={b2b!r} "
            f"busy (b)={busy!r}; lead (events less back to back)="
            f"{body - b2b!r} rest (back to back less busy)={b2b - busy!r}",
            f"body in one replay (b): first kernel to last={span!r} ms, "
            f"idle inside={(span - busy) * 1e3!r} us = "
            f"{100 * (1 - busy / span)!r} % (graph idle, lead left out); "
            f"lead (events (a) less that span)={(body - span) * 1e3!r} us",
            "iterations of (a): counter pcg.iterations={} returned={} body "
            "launches={} ({})".format(*its, "agree" if len(set(its)) == 1
                                      else "DISAGREE"),
            " ".join(f"{k}={v!r}" for k, v in seen.items())):
        log("program_trace " + line)
