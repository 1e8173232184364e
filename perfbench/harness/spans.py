"""The benchmark's own spans around its calls into the program.  While a
trace is open each span is a torch.profiler range of its name, so that the
trace can name the host's work around each idle gap of the device; outside
a trace a span costs a set insertion."""

from __future__ import annotations

import contextlib


class Spans:
    def __init__(self):
        self.names = set()
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.names.add(name)
        if not self.tracing:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield
