"""The one traffic generator: it reads a mix (``perfbench/traffic/<mix>
.json``) and drives the program by the mix's ``loop``.  The sources and
load vectors come from the configuration's reference (``Run.ref``,
``perfbench/reference/<reference>.py``), which also says how many dofs the
program has to solve for: set-up raises where the program's differ.

- ``rhs_stream``: one operator, set up and compiled once; a closed loop of
  one caller that solves to ``rel_tol`` from x0 = 0 with the next load
  vector of a ring of ``ring``, each the load of the reference's
  ``block_source`` with ``source_block`` (for Q1 diffusion: constant on
  cubes of that many elements a side, U(-1, 1) a cube), all drawn from the
  seed, assembled at set-up and held on the card.  A reservoir sample of
  ``answers_kept`` solutions, drawn from the seed, is kept on the card for
  the comparison.
- ``mc_samples``: a closed loop of Monte Carlo samples; each draws a new
  coefficient field from the seed, runs the setup and the compile, and
  solves the load of the reference's ``constant_source`` to ``rel_tol``.
  The mix's ``problem`` keys set the samples' size.

Every solve is timed from the call until its x is on the card, by CUDA
events on the card (host clock on the CPU) and by the host clock."""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench.harness import trace as tracing
from perfbench.harness.program import eig_seconds

# labels of the seeds drawn from the run's seed
COEF, RHS, KEEP, SAMPLE, WARM, TRACE = range(1, 7)


def derive(seed: int, *path: int) -> int:
    """A 32-bit seed for one use, from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 63, *path])
    return int(ss.generate_state(1, np.uint32)[0])


def _sync(run):
    if run.on_card:
        run.torch.cuda.synchronize()


def check_ndof(run, prog) -> None:
    """Raises where the program solves for another number of dofs than the
    configuration's reference holds (its answers could not be judged)."""
    want = run.ref.ndof(run.problem)
    if prog.ndof != want:
        raise ValueError(f"the program has {prog.ndof} dofs, the reference "
                         f"{run.cell.config['reference']!r} {want}")


class RhsStream:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.records = []

    def setup(self):
        run, mix, torch = self.run, self.mix, self.run.torch
        p = run.problem
        self.coef_seed = derive(run.seed, COEF)
        with run.spans("setup.problem"):
            product = run.entry.problem(p, self.coef_seed, run.device)
        with run.spans("setup.compile"):
            self.prog = run.entry.compile(p, product, run.device)
            _sync(run)
        del product
        check_ndof(run, self.prog)
        ref = run.ref
        rng = np.random.default_rng(derive(run.seed, RHS))
        self.sources = [ref.block_source(p, mix["source_block"], rng)
                        for _ in range(mix["ring"])]
        self.ring = torch.stack([
            torch.as_tensor(ref.load_vector(p, f), dtype=torch.float32)
            for f in self.sources]).to(run.device)
        self.kept = torch.zeros((mix["answers_kept"], self.prog.ndof),
                                dtype=torch.float32, device=run.device)
        self.kept_ring = [None] * mix["answers_kept"]
        for k in range(mix["warmup_requests"]):
            self.solve(self.ring[k % mix["ring"]])
        _sync(run)

    def solve(self, b):
        return self.prog.solve(b, self.mix["rel_tol"], self.mix["max_iter"])

    def window(self, seconds: float) -> tuple:
        run, mix, torch = self.run, self.mix, self.run.torch
        keep_rng = np.random.default_rng(derive(run.seed, KEEP))
        K, R = mix["answers_kept"], mix["ring"]
        events = []
        t0 = time.perf_counter()
        k = 0
        while True:
            with run.spans("rhs.next"):
                i = k % R
                b = self.ring[i]
            h0 = time.perf_counter()
            if run.on_card:
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record()
            with run.spans("pcg.solve"):
                x, it = self.solve(b)
                if run.on_card:
                    z.record()
                    z.synchronize()
            h1 = time.perf_counter()
            with run.spans("answer.keep"):
                slot = k if k < K else int(keep_rng.integers(0, k + 1))
                if slot < K:
                    self.kept[slot].copy_(x)
                    self.kept_ring[slot] = i
            self.records.append({"ring": i, "it": it,
                                 "host_ms": (h1 - h0) * 1e3})
            events.append((a, z) if run.on_card else None)
            k += 1
            if h1 - t0 >= seconds:
                break
        t1 = time.perf_counter()
        for rec, ev in zip(self.records, events):
            rec["solve_ms"] = (ev[0].elapsed_time(ev[1]) if ev
                               else rec["host_ms"])
        return t0, t1

    def failed(self) -> int:
        return sum(r["it"] >= self.mix["max_iter"] for r in self.records)

    def traced(self):
        def stretch():
            for k in range(self.mix["trace_requests"]):
                with self.run.spans("rhs.next"):
                    b = self.ring[k % self.mix["ring"]]
                with self.run.spans("pcg.solve"):
                    self.solve(b)
        return tracing.trace(stretch, self.run.torch, self.run.spans)

    def free(self):
        """Drop the program; keep what the comparison reads."""
        del self.prog

    def answers(self) -> list:
        """(coefficient seed, source per element, x) of the kept solves."""
        return [(self.coef_seed, self.sources[i], self.kept[s])
                for s, i in enumerate(self.kept_ring) if i is not None]


class McSamples:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.records = []

    def setup(self):
        run, torch, ref = self.run, self.run.torch, self.run.ref
        self.source = ref.constant_source(run.problem)
        self.b = torch.as_tensor(ref.load_vector(run.problem, self.source),
                                 dtype=torch.float32, device=run.device)
        for w in range(self.mix["warmup_requests"]):
            self.sample(derive(run.seed, WARM, w))

    def sample(self, seed: int) -> dict:
        run, p = self.run, self.run.problem
        spans = run.spans
        t0 = time.perf_counter()
        with spans("sample.setup"):
            e0 = eig_seconds()
            product = run.entry.problem(p, seed, run.device)
            eig = eig_seconds() - e0
        t1 = time.perf_counter()
        with spans("sample.compile"):
            prog = run.entry.compile(p, product, run.device)
            del product
            _sync(run)
        t2 = time.perf_counter()
        check_ndof(run, prog)
        with spans("sample.solve"):
            x, it = prog.solve(self.b, self.mix["rel_tol"],
                               self.mix["max_iter"])
            x = x.cpu()
        del prog
        if self.mix.get("collect_each"):
            gc.collect()
        t3 = time.perf_counter()
        return {"seed": seed, "it": it, "x": x, "eig_s": eig,
                "setup_s": t1 - t0, "compile_s": t2 - t1,
                "solve_s": t3 - t2}

    def window(self, seconds: float) -> tuple:
        t0 = time.perf_counter()
        i = 0
        while True:
            self.records.append(self.sample(derive(self.run.seed, SAMPLE, i)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return t0, time.perf_counter()

    def failed(self) -> int:
        return sum(r["it"] >= self.mix["max_iter"] for r in self.records)

    def traced(self):
        return tracing.trace(
            lambda: self.sample(derive(self.run.seed, TRACE, 0)),
            self.run.torch, self.run.spans)

    def free(self):
        pass

    def answers(self) -> list:
        return [(r["seed"], self.source, r["x"]) for r in self.records]


LOOPS = {"rhs_stream": RhsStream, "mc_samples": McSamples}
