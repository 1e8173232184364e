"""Idle share inside one replay of the PCG body's graph: 100 (1 - median
busy / median length).  Busy is the union of the kernels of the replay's
``cudaGraphLaunch`` correlation id, under the profiler; the length is the
replay's span between the program's CUDA events, without the profiler
(harness/program_trace.py)."""

from perfbench.harness.program_trace import program_trace


def read(run):
    pt = program_trace(run)
    return None if pt is None else pt.graph_idle_pct
