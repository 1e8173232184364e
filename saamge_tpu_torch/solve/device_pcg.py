"""The port's PCG loop, shared by the structured and the general path,
and the CUDA graphs that run it and the V-cycle on the card.

MFEM CGSolver semantics, as the JAX package's ``pcg_solve`` and
``struct_pcg_solve``: convergence when (B r, r) <= max(rel_tol^2
(B r0, r0), abs_tol^2).

``PCGRunner`` owns the loop's state as static tensors on the hierarchy's
device: the vectors b, x, r, d and Ad, the 0-d scalars nom, lim, rel_tol
and abs_tol (a new tolerance is a new value, not a new capture, as the
JAX package's device scalars), and the flag go = nom > lim.  Two
functions rewrite that state in place: ``prologue`` (z = M r0, nom0 =
z . r0, lim, d = z, Ad = A z) and ``body``, one iteration in the op
order of the JAX ``_struct_pcg`` / ``_pcg_solve`` body.  Both take the
operator, the preconditioner and the inner product from the solve that
runs them; the runner keeps none of them.

On the card the two are captured once each in a ``torch.cuda.CUDAGraph``
(after a warm-up on a side stream, which builds the kernels and does
each launcher's first-use attribute and occupancy queries), the JAX
package's jitted ``lax.while_loop`` in PyTorch's terms.  A solve copies
b (and x0) and the tolerances into the state, replays the prologue, and
replays the body while the flag says go: the graph computes the flag,
which is copied to a pinned host flag and read after an event, one small
read per iteration.  ``it`` counts replays on the host and ``max_iter``
caps it there, so the iteration count is the while_loop's exactly.  On
the CPU the same prologue and body run eagerly; ``graph=False`` asks for
that eager loop on the card.  Nothing else chooses it: a capture that
fails raises.

``GraphedApply`` is one V-cycle the same way: a static input buffer, the
function of the first call captured, the output cloned on return.

Each hierarchy owns its runners and V-cycle graph in ``solve_graphs(h)``,
remade when its buffers have moved (``.to``) and left behind by
``copy.deepcopy``.  The table holds no reference back to the hierarchy:
the functions that reach it (bound methods, closures over it) are
arguments of each solve and each apply, used there to capture or to run
eagerly, and a replay runs no Python.  So a hierarchy, its graphs and
their memory go at its last ``del``, with no wait for a cyclic garbage
collection.  Graph temporaries come from the graphs' private memory
pools (one shared by a runner's two graphs, one for the V-cycle).

Launch counters: the kernels' wrappers count a launch in
utils/logging.TIMERS when they run (ops/__init__.py), so an eager solve
counts every launch, and a graph solve only those of the warm-up and the
capture (a replay runs no Python).  A run that counts the kernels of a
replay reads the profiler's kernel records.

Tracing (utils/logging.TIMERS): every solve is the phases
``pcg.prologue`` (load and prologue launch) and ``pcg.loop`` (whose call
count is the solves) and adds its iterations to the counter
``pcg.iterations``; a capture is the phase ``graph.capture`` and adds to
``graph.captures``; an entry of ``solve_graphs(h)`` thrown away because
the buffers moved adds to ``graph.remade``.  While ``TIMERS.tracing`` is
on, each flag wait is a ``pcg.flag_wait`` range and each body launch a
``pcg.launch`` range, and on the card a pair of CUDA events brackets
every launch, the prologue's and each body's: the runner keeps the last
solve's pairs as ``timeline`` (``timeline_ms`` reads them), times on the
device's own clock that need no profiler.  With tracing off the
iteration loop is the one above."""

from __future__ import annotations

from contextlib import nullcontext
from functools import partial
from typing import Callable, Optional

import torch

from saamge_tpu_torch.utils.logging import TIMERS


def _warm_up(*fns) -> None:
    """Run ``fns`` once in order on a side stream, the warm-up that
    ``torch.cuda.graph`` asks for before a capture."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    cur.wait_stream(side)


class PCGRunner:
    """The PCG loop on static state; ``with_x0`` runs the prologue from
    the initial guess in ``x``.  ``like`` may be a sharded vector
    (parallel/mesh.ShardTensor), whose shards all hold the same scalars
    and flag."""

    def __init__(self, like: torch.Tensor, with_x0: bool = False):
        self.with_x0 = with_x0
        self.b, self.x, self.r, self.d, self.Ad = (
            torch.zeros_like(like) for _ in range(5))
        self.nom, self.lim, self.rel_tol, self.abs_tol = (
            like.new_zeros(()) for _ in range(4))
        self.go = like.new_zeros((), dtype=torch.bool)
        # the flag the host reads: a sharded flag's first shard
        self.flag = getattr(self.go, "lead", self.go)
        self.graphs = None        # (prologue, body) once captured
        # the last traced solve's (name, start, end) CUDA events, on the
        # card; drawn from a pool that the next traced solve records again
        self.timeline = None
        self._events = []
        if like.device.type == "cuda":
            self.go_host = torch.zeros((), dtype=torch.bool,
                                       pin_memory=True)
            self.go_ready = torch.cuda.Event()

    def prologue(self, matvec: Callable, precond: Callable,
                 dot: Callable) -> None:
        if self.with_x0:
            r = self.b - matvec(self.x)
        else:
            self.x.zero_()
            r = self.b
        z = precond(r)
        nom = dot(z, r)
        self.r.copy_(r)
        self.d.copy_(z)
        self.Ad.copy_(matvec(z))
        self.nom.copy_(nom)
        torch.maximum(nom * self.rel_tol * self.rel_tol,
                      self.abs_tol * self.abs_tol, out=self.lim)
        torch.gt(self.nom, self.lim, out=self.go)

    def body(self, matvec: Callable, precond: Callable,
             dot: Callable) -> None:
        x, r, d, Ad, nom = self.x, self.r, self.d, self.Ad, self.nom
        alpha = nom / dot(d, Ad)
        x.add_(alpha * d)
        r.sub_(alpha * Ad)
        z = precond(r)
        betanom = dot(r, z)
        torch.add(z, (betanom / nom) * d, out=d)
        Ad.copy_(matvec(d))
        nom.copy_(betanom)
        torch.gt(nom, self.lim, out=self.go)

    def _load(self, b, x0, rel_tol: float, abs_tol: float) -> None:
        self.b.copy_(b)
        if self.with_x0:
            self.x.copy_(x0)
        self.rel_tol.fill_(rel_tol)
        self.abs_tol.fill_(abs_tol)

    def _capture(self, prologue: Callable, body: Callable):
        """Warm up on a side stream, then capture the prologue and the
        body (one memory pool, captured and replayed in that order)."""
        with TIMERS.phase("graph.capture"):
            _warm_up(prologue, body)
            pro, graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(pro):
                prologue()
            with torch.cuda.graph(graph, pool=pro.pool()):
                body()
        TIMERS.count("graph.captures", 2)
        return pro, graph

    def _going(self) -> bool:
        """The flag go, read on the host after the work that sets it."""
        if self.flag.device.type != "cuda":
            return bool(self.flag)
        self.go_host.copy_(self.flag, non_blocking=True)
        self.go_ready.record()
        self.go_ready.synchronize()
        return bool(self.go_host)

    def _launch(self, name: str, fn: Callable) -> None:
        """``fn()`` between a pair of the pool's CUDA events, appended to
        the timeline (tracing on the card)."""
        k = 2 * len(self.timeline)
        if len(self._events) < k + 2:
            self._events += [torch.cuda.Event(enable_timing=True)
                             for _ in range(2)]
        start, end = self._events[k:k + 2]
        start.record()
        fn()
        end.record()
        self.timeline.append((name, start, end))

    def _traced_loop(self, body: Callable, max_iter: int,
                     on_card: bool) -> int:
        """The iteration loop with a range around each flag wait and each
        launch, and the launches timed by events on the card."""
        it = 0
        while it < max_iter:
            with TIMERS.phase("pcg.flag_wait"):
                go = self._going()
            if not go:
                break
            with TIMERS.phase("pcg.launch"):
                if on_card:
                    self._launch("body", body)
                else:
                    body()
            it += 1
        return it

    def timeline_ms(self) -> list:
        """The last traced solve's launches as (name, start ms, end ms)
        from the prologue's start event, on the device's clock; waits for
        the last event."""
        a0 = self.timeline[0][1]
        self.timeline[-1][2].synchronize()
        return [(name, a0.elapsed_time(a), a0.elapsed_time(z))
                for name, a, z in self.timeline]

    def solve(self, matvec: Callable, precond: Callable, dot: Callable,
              b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              rel_tol: float = 1e-6, abs_tol: float = 0.0,
              max_iter: int = 200, graph: bool = True):
        """PCG with operator ``matvec``, preconditioner ``precond`` and
        inner product ``dot`` (a sharded solve counts the planes that two
        shards share once, parallel/structured_sharded.py): captured from
        them on the first solve on the card, run eagerly with them on the
        CPU or with ``graph=False``.  Returns (x, iterations, final (B r,
        r)); x and the scalar are copies, so the next solve leaves them as
        they are."""
        on_card = self.b.device.type == "cuda"
        with torch.cuda.device(self.b.device) if on_card else nullcontext():
            prologue = partial(self.prologue, matvec, precond, dot)
            body = partial(self.body, matvec, precond, dot)
            if graph and on_card:
                if self.graphs is None:
                    # the warm-up runs on the loaded state
                    self._load(b, x0, rel_tol, abs_tol)
                    self.graphs = self._capture(prologue, body)
                prologue, body = (g.replay for g in self.graphs)
            tracing = TIMERS.tracing
            with TIMERS.phase("pcg.prologue"):
                self._load(b, x0, rel_tol, abs_tol)
                if tracing and on_card:
                    self.timeline = []
                    self._launch("prologue", prologue)
                else:
                    prologue()
            with TIMERS.phase("pcg.loop"):
                if tracing:
                    it = self._traced_loop(body, max_iter, on_card)
                else:
                    it = 0
                    while it < max_iter and self._going():
                        body()
                        it += 1
            TIMERS.count("pcg.iterations", it)
            return self.x.clone(), it, self.nom.clone()


class GraphedApply:
    """y = fn(x) for x of one shape and dtype, ``fn`` of the first call
    captured in a CUDA graph on ``like``'s card: a static input buffer,
    replayed, the output cloned on return."""

    def __init__(self, like: torch.Tensor):
        self.x = torch.zeros_like(like)
        self.graph = self.y = None

    def __call__(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(self.x.device):
            self.x.copy_(x)
            if self.graph is None:
                with TIMERS.phase("graph.capture"):
                    _warm_up(lambda: fn(self.x))
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        self.y = fn(self.x)
                TIMERS.count("graph.captures")
                self.graph = graph
            self.graph.replay()
            return self.y.clone()


class SolveGraphs:
    """A hierarchy's runners and graphs by key, each kept with the
    addresses of the hierarchy's buffers when it was made and remade
    when they differ.  ``copy.deepcopy`` gives an empty table."""

    def __init__(self):
        self.items = {}

    def __deepcopy__(self, memo):
        return SolveGraphs()

    def get(self, key, h: torch.nn.Module, make: Callable):
        where = tuple((t.device, t.data_ptr()) for t in h.buffers())
        hit = self.items.get(key)
        if hit is None or hit[0] != where:
            if hit is not None:
                TIMERS.count("graph.remade")
            self.items.pop(key, None)
            hit = (where, make())
            self.items[key] = hit
        return hit[1]


def solve_graphs(h: torch.nn.Module) -> SolveGraphs:
    table = h.__dict__.get("_solve_graphs")
    if table is None:
        table = h.__dict__["_solve_graphs"] = SolveGraphs()
    return table


def pcg(h: torch.nn.Module, matvec: Callable, precond: Callable,
        b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        rel_tol: float = 1e-6, abs_tol: float = 0.0, max_iter: int = 200,
        graph: bool = True, dot: Callable = torch.dot):
    """PCG on hierarchy ``h``'s cached runner for b's dtype and device
    (and x0 or none); returns (x, iterations, final (B r, r))."""
    # the key needs no matvec, preconditioner or dot: a hierarchy has one
    # of each, and every compile_structured configuration (level count,
    # coarsest restriction, mid format and route) and every sharding of
    # one (parallel/structured_sharded.py) is a hierarchy of its own
    key = ("pcg", b.dtype, b.device, x0 is not None)
    runner = solve_graphs(h).get(key, h,
                                 lambda: PCGRunner(b, x0 is not None))
    return runner.solve(matvec, precond, dot, b, x0, rel_tol, abs_tol,
                        max_iter, graph)


def graphed(h: torch.nn.Module, fn: Callable, b: torch.Tensor,
            graph: bool = True) -> torch.Tensor:
    """fn(b): on the card by default through ``h``'s cached graph of
    ``fn`` for b's dtype, eagerly on the CPU or with ``graph=False``."""
    if not (graph and b.device.type == "cuda"):
        return fn(b)
    key = ("graphed", b.dtype, b.device)   # one V-cycle a hierarchy, as pcg
    return solve_graphs(h).get(key, h, lambda: GraphedApply(b))(fn, b)
