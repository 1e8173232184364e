"""``pcg.iters`` of the full-capacity cell, a metric of its own so that its
bound (or the end-to-end metric it moves) is that cell's."""

from perfbench.harness.spec import load_module

read = load_module("metrics", "pcg.iters").read
