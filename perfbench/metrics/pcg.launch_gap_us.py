"""Device time between two graph launches of one PCG solve: from one
replay's end event to the next replay's start event (CUDA events the
program records around each launch while ``TIMERS.tracing`` is on, no
profiler), median over the mix's traced stretch of solves
(harness/program_trace.py)."""

from perfbench.harness.program_trace import program_trace


def read(run):
    pt = program_trace(run)
    return None if pt is None else pt.launch_gap_us
