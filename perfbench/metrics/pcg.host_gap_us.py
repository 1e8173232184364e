"""What the host adds to each PCG iteration of the graph loop, median over
the window's solves: each solve's host-clock time less the prologue, over
its iterations, less one iteration's device time (the captured prologue and
body replayed back to back between CUDA events)."""

import statistics

from perfbench.harness.timing import host_gap_us, replay_ms


def read(run):
    loop = run.loop
    prog = getattr(loop, "prog", None)
    if run.mix["loop"] != "rhs_stream" or prog is None or not run.on_card:
        return None
    graphs = prog.graphs(loop.ring[0])
    if graphs is None:
        return None
    pro, body = (replay_ms(g, run.torch) for g in graphs)
    return statistics.median(host_gap_us(r["host_ms"], r["it"], pro, body)
                             for r in run.records)
