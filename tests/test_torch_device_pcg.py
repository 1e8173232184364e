"""The port's PCG loop (solve/device_pcg.py: PCGRunner's prologue and
body, the code that the card captures in CUDA graphs, run eagerly on the
CPU) against the JAX package's jitted while_loops ``_struct_pcg`` and
``_pcg_solve`` and against a textbook copy of the loop.

Fixtures: the structured flagship of tests/test_torch_structured.py (n=16,
4^3 bricks, superbricks (2,2,2)), all f32 against JAX (the Pallas
kernels in interpret mode) and bf16 for the textbook loop; the 3-level
quad_mesh(20) general hierarchy of tests/test_torch_compiled.py in f64.
Tolerances: iterations equal everywhere; x within 1e-5 relative of JAX
in f32 (the V-cycles round at different points) and 1e-9 in f64; x, the
iteration count and (B r, r) bit-equal to the textbook loop, which does
the same operations in the same order."""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from saamge_tpu.solve import compiled as JC  # noqa: E402
from saamge_tpu.solve import structured as JS  # noqa: E402

from saamge_tpu_torch import (compile_structured,  # noqa: E402
                              flagship_problem, struct_pcg_solve)
from saamge_tpu_torch.api import (SpectralAMGSolver,  # noqa: E402
                                  checkerboard_coef)
from saamge_tpu_torch.config import SolverOptions  # noqa: E402
from saamge_tpu_torch.fem import assemble  # noqa: E402
from saamge_tpu_torch.fem.mesh import quad_mesh  # noqa: E402
from saamge_tpu_torch.parallel.mesh import ShardMesh  # noqa: E402
from saamge_tpu_torch.parallel.structured_sharded import (  # noqa: E402
    make_struct_sharded_pcg, scatter_fine, shard_structured)
from saamge_tpu_torch.solve import compiled as C  # noqa: E402
from saamge_tpu_torch.solve.device_pcg import solve_graphs  # noqa: E402

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
TOLS = (1e-6, 1e-8)
PATHS = ("structured", "general")


def textbook_pcg(matvec, precond, b, x0=None, rel_tol=1e-6, abs_tol=0.0,
                 max_iter=200):
    """The port's loop before it ran on static state: new tensors for
    every update, the stopping test read on the host."""
    x, r = (torch.zeros_like(b), b) if x0 is None else (x0, b - matvec(x0))
    z = precond(r)
    nom = torch.dot(z, r)
    lim = torch.clamp(nom * rel_tol * rel_tol, min=abs_tol * abs_tol)
    d = z
    Ad = matvec(d)
    it = 0
    while it < max_iter and bool(nom > lim):
        alpha = nom / torch.dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        betanom = torch.dot(r, z)
        d = z + (betanom / nom) * d
        Ad = matvec(d)
        nom = betanom
        it += 1
    return x, it, nom


@pytest.fixture(scope="module")
def structured():
    """(port all-f32, port bf16, JAX all-f32 hierarchies, b)."""
    ml, b, geo, supers = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    hj = JS.compile_structured(
        ml, JS.BrickGeometry(geo.bricks, geo.brick_elems),
        super_bricks=supers, wavefront=True)
    h32 = compile_structured(ml, geo, supers, smoother_dtype=F32,
                             rp_dtype=F32, mid_dtype=F32, device="cpu")
    h16 = compile_structured(ml, geo, supers, device="cpu")
    return h32, h16, hj, b.astype(np.float32)


@pytest.fixture(scope="module")
def general():
    """(port f64, JAX f64 hierarchies, b)."""
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    ml = SpectralAMGSolver(A, mesh, em, SolverOptions(
        correct_nulspace=False, num_levels=3, first_elems_per_agg=16,
        elems_per_agg=4), ess_attr_marker=ess).ml
    return (C.compile_hierarchy(ml, F64, device="cpu"),
            JC.compile_hierarchy(ml, dtype=jnp.float64), b)


def _solves(path, structured, general):
    """(port solve, JAX solve, textbook solve, b, tolerance on x) of a
    path; each solve takes (b, **PCG options) as numpy / keywords."""
    if path == "structured":
        h, h16, hj, b = structured

        def port(b, **kw):
            return struct_pcg_solve(h, torch.as_tensor(b), **kw)

        def ref(b, **kw):
            x, it, nom = JS.struct_pcg_solve(hj, jnp.asarray(b), **kw)
            return np.asarray(x), int(it), float(nom)

        def book(b, **kw):
            return textbook_pcg(h16.matvec0, h16.vcycle,
                                torch.as_tensor(b), **kw), \
                struct_pcg_solve(h16, torch.as_tensor(b), **kw)
        return port, ref, book, b, 1e-5
    h, hj, b = general

    def port(b, x0=None, **kw):
        return C.pcg_solve(h, torch.as_tensor(b), x0=None if x0 is None
                           else torch.as_tensor(x0), **kw)

    def ref(b, x0=None, **kw):
        x, it, nom = JC.pcg_solve(hj, jnp.asarray(b), x0=None if x0 is None
                                  else jnp.asarray(x0), **kw)
        return np.asarray(x), int(it), float(nom)

    def book(b, x0=None, **kw):
        bt = torch.as_tensor(b)
        x0 = None if x0 is None else torch.as_tensor(x0)
        return textbook_pcg(h.levels[0].matvec, lambda r: C.precond(h, r),
                            bt, x0=x0, **kw), C.pcg_solve(h, bt, x0=x0, **kw)
    return port, ref, book, b, 1e-9


def _agree(got, want, tol):
    x, it, _ = got
    xj, itj, _ = want
    assert it == itj
    scale = max(np.abs(xj).max(), 1e-300)
    assert np.abs(x.numpy() - xj).max() <= tol * scale


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("path", PATHS)
def test_iterations_and_x_match_jax(path, tol, structured, general):
    port, ref, _, b, xtol = _solves(path, structured, general)
    _agree(port(b, rel_tol=tol), ref(b, rel_tol=tol), xtol)


@pytest.mark.parametrize("path", PATHS)
def test_bit_equal_to_textbook_loop(path, structured, general):
    _, _, book, b, _ = _solves(path, structured, general)
    (xb, itb, nomb), (x, it, nom) = book(b, rel_tol=1e-8)
    assert it == itb > 0
    assert torch.equal(x, xb) and torch.equal(nom, nomb)


def test_general_x0_branch(general):
    port, ref, book, b, xtol = _solves("general", None, general)
    x0 = np.random.default_rng(11).standard_normal(b.shape[0])
    _agree(port(b, x0=x0, rel_tol=1e-8), ref(b, x0=x0, rel_tol=1e-8), xtol)
    (xb, itb, nomb), (x, it, nom) = book(b, x0=x0, rel_tol=1e-8)
    assert it == itb > 0
    assert torch.equal(x, xb) and torch.equal(nom, nomb)


@pytest.mark.parametrize("path", PATHS)
def test_zero_rhs_takes_no_iteration(path, structured, general):
    port, ref, _, b, _ = _solves(path, structured, general)
    zero = np.zeros_like(b)
    x, it, nom = port(zero)
    assert it == 0 == ref(zero)[1]
    assert not x.any() and float(nom) == 0.0


@pytest.mark.parametrize("path", PATHS)
def test_max_iter_caps(path, structured, general):
    port, ref, _, b, xtol = _solves(path, structured, general)
    got = port(b, rel_tol=1e-12, max_iter=3)
    assert got[1] == 3
    _agree(got, ref(b, rel_tol=1e-12, max_iter=3), xtol)


@pytest.mark.parametrize("path", PATHS)
def test_abs_tol_only_stop(path, structured, general):
    port, ref, _, b, xtol = _solves(path, structured, general)
    nom0 = float(port(b, max_iter=0)[2])
    kw = {"rel_tol": 0.0, "abs_tol": float(np.sqrt(nom0)) * 1e-4}
    got = port(b, **kw)
    assert 0 < got[1] < port(b, rel_tol=1e-8)[1]
    _agree(got, ref(b, **kw), xtol)


@pytest.mark.parametrize("path", PATHS)
def test_fresh_rhs_through_one_runner(path, structured, general):
    """Two right-hand sides through one cached runner: each equals the
    solve of a hierarchy with no runner yet (a deep copy has none)."""
    h = structured[0] if path == "structured" else general[0]
    port, _, _, b, _ = _solves(path, structured, general)
    b2 = np.random.default_rng(5).standard_normal(b.shape[0]) \
        .astype(b.dtype)
    port(b, rel_tol=1e-8)
    table = solve_graphs(h).items
    runners = {k: v[1] for k, v in table.items()}
    outs = [port(bb, rel_tol=1e-8) for bb in (b2, b)]
    assert {k: v[1] for k, v in table.items()} == runners
    fresh = copy.deepcopy(h)
    assert not solve_graphs(fresh).items
    solve = struct_pcg_solve if path == "structured" else C.pcg_solve
    for bb, (x, it, nom) in zip((b2, b), outs):
        xf, itf, nomf = solve(fresh, torch.as_tensor(bb), rel_tol=1e-8)
        fresh = copy.deepcopy(h)
        assert it == itf and torch.equal(x, xf) and torch.equal(nom, nomf)


def _solve_once(path, h, b):
    if path == "structured":
        return struct_pcg_solve(h, b)
    if path == "general":
        return C.pcg_solve(h, b)
    return make_struct_sharded_pcg(h)(scatter_fine(h, b))


@pytest.mark.parametrize("path", PATHS + ("sharded",))
def test_solved_hierarchy_freed_at_del(path, structured, general):
    """A hierarchy's solve table holds no reference back to it: with the
    cyclic garbage collector off, a hierarchy that has solved goes at
    its last ``del``; while it is kept, a second solve reuses its
    runner."""
    if path == "general":
        h, b = copy.deepcopy(general[0]), torch.as_tensor(general[2])
    else:
        h16, b = structured[1], torch.as_tensor(structured[3])
        h = (copy.deepcopy(h16) if path == "structured"
             else shard_structured(h16, ShardMesh(["cpu"] * 2)))
    gc.disable()
    try:
        _solve_once(path, h, b)
        table = solve_graphs(h).items
        runners = [v[1] for v in table.values()]
        _solve_once(path, h, b)
        assert len(runners) == 1
        assert [v[1] for v in table.values()] == runners
        del table, runners
        ref = weakref.ref(h)
        del h
        assert ref() is None
    finally:
        gc.enable()
