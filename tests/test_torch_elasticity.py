"""3D linear elasticity on the port's general path (``elasticity_problem``
-> ``compile_hierarchy`` with its finest level in the node-block format ->
``pcg_solve``), held to the benchmark's plain float64 reference
(perfbench/reference/q1_elasticity.py) on the CPU at n <= 8, c_e =
10^U(-2, 2) from the seed, one face clamped.  On the CPU the node-block
products run their plain torch version (ops/vstencil.vstencil_plain).
Imports no JAX."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from perfbench.reference import q1_elasticity as q
from saamge_tpu_torch import (compile_hierarchy, elasticity_problem,
                              general_problem, pcg_solve)
from saamge_tpu_torch.ops.sparse import DIA, ELL, NodeBlock
from saamge_tpu_torch.ops.vstencil import vstencil, vstencil_plain
from saamge_tpu_torch.utils.logging import TIMERS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, CONTRAST = 2 ** 31 + 9, 2.0


def problem(n, seed=SEED):
    """(ml, A) at n with the cell's agglomerate sizes scaled to n^3 (32
    and 8 elements an agglomerate), the setup on the CPU."""
    ml, A, _ = elasticity_problem(
        n=n, contrast=CONTRAST, seed=seed, first_elems_per_agg=32,
        elems_per_agg=8, device_setup=True, device="cpu")
    return ml, A


@pytest.fixture(scope="module")
def n8():
    ml, A = problem(8)
    return ml, A, compile_hierarchy(ml, torch.float32, device="cpu")


def haloed(nb: NodeBlock, x: torch.Tensor) -> torch.Tensor:
    """x haloed for ``nb`` in its own dtype (``NodeBlock.pad`` makes f32)."""
    h = nb.bs * nb.halo
    return torch.nn.functional.pad(x, (h, h))


@pytest.mark.parametrize("n", [4, 5])
def test_reference_operator_is_the_assembled_one(n):
    """(a) The reference's element-by-element operator of the seed's
    field equals the port's assembled, clamped A x in f64: both are exact
    integrals of the same element matrices (2-point Gauss integrates the
    Q1 gradient products exactly), so only f64 rounding of a 24-term sum
    a row separates them: 1e-12 relative.  bf16 values (rounding 4e-3)
    are off by ~1e-3."""
    _, A = problem(n)
    op = q.Q1Elasticity(n, q.coefficients(n, CONTRAST, SEED))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.shape[0]))
    want = torch.as_tensor(A @ x.numpy())
    assert A.shape[0] == q.ndof({"n": n})
    err = float((op(x) - want).norm() / want.norm())
    assert err < 1e-12
    bf = sp.csr_matrix((torch.as_tensor(A.data).to(torch.bfloat16)
                        .double().numpy(), A.indices, A.indptr), A.shape)
    assert float(np.linalg.norm(bf @ x.numpy() - want.numpy())
                 / want.norm()) > 1e-12


@pytest.mark.parametrize("n", [6, 5])
def test_node_block_product_is_the_csr_product(n):
    """(b) The node-block format of the finest operator holds it whole:
    27 node offsets, its plain product in f64 equal to the CSR product
    to f64 rounding of an 81-term sum (1e-13 relative), each mode of
    ``vstencil`` on haloed vectors with a zero halo out; n = 5 leaves the
    last chunk of 256 nodes ragged."""
    _, A = problem(n)
    nb = NodeBlock.from_csr(A, torch.float64)
    assert len(nb.offsets) == 27 and nb.nodes == (n + 1) ** 3
    assert nb.halo == (n + 1) ** 2 + n + 2
    rng = np.random.default_rng(n)
    x, b = (torch.as_tensor(rng.standard_normal(A.shape[0]))
            for _ in range(2))
    want = torch.as_tensor(A @ x.numpy())
    y = vstencil(nb, "spmv", haloed(nb, x))
    h = 3 * nb.halo
    assert float(y[:h].abs().max()) == 0 == float(y[-h:].abs().max())
    assert float((nb.unpad(y) - want).norm() / want.norm()) < 1e-13
    r = nb.unpad(vstencil(nb, "residual", haloed(nb, x), haloed(nb, b)))
    assert float((r - (b - want)).norm() / want.norm()) < 1e-13
    assert NodeBlock.try_from_csr(A[:-1, :-1]) is None     # not whole nodes
    perm = np.random.default_rng(0).permutation(A.shape[0] // 3)
    p3 = (3 * perm[:, None] + np.arange(3)).reshape(-1)
    with pytest.raises(ValueError):          # nodes renumbered at random
        NodeBlock.from_csr(A[p3][:, p3])


def _ell_chain(lv, A_csr, b, x):
    """The level's roots and the residual by the plain ELL products, as
    solve/compiled.py chains them on an ELL level."""
    ell = ELL.from_csr(A_csr, torch.float32)
    for tau in lv.roots:
        x = x + (lv.dinv * (b - ell.matvec(x))) / tau
    return x, b - ell.matvec(x)


def test_plain_chain_matches_the_ell_chain(n8):
    """(c) The finest level is node-block and chained; its plain chain (10
    roots and the residual, one call) matches the plain ELL chain of the
    same level.  Both sum 81 f32 products a row, in other orders, and
    divide by tau where the chain multiplies by its f32 1/tau: a few f32
    roundings a root, amplified by the roots (4e-7 measured on x); the
    residual, b less a near-equal A x, loses ~10x to cancellation.  A
    bf16 operator is off by ~1e-3 and fails both."""
    ml, A, h = n8
    lv = h.levels[0]
    assert isinstance(lv.A, NodeBlock) and lv.blocked and not lv.fused
    assert len(lv.inv_taus) == 10
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.standard_normal(A.shape[0]), dtype=torch.float32)
    x0 = torch.zeros_like(b)
    TIMERS.reset()
    xh, rh = lv.chain_h(lv.A.pad(b), lv.A.pad(x0), emit_residual=True)
    assert TIMERS.counters.get("vstencil.plain") == 1
    assert not TIMERS.counters.get("vstencil.kernel")
    xe, re = _ell_chain(lv, A, b, x0)
    ex = float((lv.A.unpad(xh) - xe).norm() / xe.norm())
    er = float((lv.A.unpad(rh) - re).norm() / re.norm())
    assert ex < 4e-6 and er < 4e-5, (ex, er)
    bf = NodeBlock(lv.A.vals.to(torch.bfloat16).float(), lv.A.offsets)
    xb, rb = vstencil_plain(bf, "chain", bf.pad(b), bf.pad(b), lv.dinvh,
                            lv.inv_taus, emit_residual=True)
    assert float((bf.unpad(xb) - xe).norm() / xe.norm()) > 4e-6
    assert float((bf.unpad(rb) - re).norm() / re.norm()) > 4e-5


def _limits():
    with open(os.path.join(REPO, "perfbench", "limits",
                           "elasticity.rhs_stream.json")) as f:
        return json.load(f)["limits"]


def test_whole_path_meets_the_cell_limits(n8):
    """(d) A block body force solved to 1e-8 by the port (f32 PCG, graph
    off on the CPU) passes the reference's residuals under the cell's
    limits (check blocks of n / 4 elements, as the cell's 10 at n=40);
    the same answer rounded to bf16 fails them."""
    ml, A, h = n8
    n = 8
    prob = {"n": n, "contrast": CONTRAST, "clamp": "x0"}
    f = q.block_source(prob, 4, np.random.default_rng(5))
    b64 = torch.as_tensor(q.load_vector(prob, f))
    x, it, _ = pcg_solve(h, b64.float(), rel_tol=1e-8, max_iter=200,
                         graph=False)
    assert it < 200
    op = q.operator(prob, SEED, "cpu")
    lim = _limits()
    got = q.residuals(op, b64, x.double(), n // 4)
    assert all(got[k] <= lim[k] for k in lim), (got, lim)
    bad = q.residuals(op, b64, x.to(torch.bfloat16).double(), n // 4)
    assert any(bad[k] > lim[k] for k in lim), (bad, lim)


def test_scalar_levels_keep_their_formats():
    """(e) A scalar general problem keeps its finest DIA level on the
    fused smoother, and no node-block route runs."""
    ml, _, b = general_problem(n=8, elems_per_agg=64, device_setup=True,
                               device="cpu")
    assert ml.vdim == 1
    h = compile_hierarchy(ml, torch.float32, device="cpu")
    lv = h.levels[0]
    assert isinstance(lv.A, DIA) and lv.fused and not lv.blocked
    assert not any(getattr(v, "blocked") for v in h.levels)
    TIMERS.reset()
    x, it, _ = pcg_solve(h, torch.as_tensor(b, dtype=torch.float32),
                         rel_tol=1e-6, graph=False)
    assert it < 30
    assert not any(k.startswith("vstencil") for k in TIMERS.counters)


def test_f64_hierarchy_keeps_the_scalar_choice(n8):
    """The node-block format is the f32 kernel's: an f64 compile of the
    same setup stores the finest level as ``device_matrix`` picks for any
    operator (ELL here: 99 diagonals, too wide a band)."""
    ml, A, _ = n8
    h = compile_hierarchy(ml, torch.float64, device="cpu")
    assert isinstance(h.levels[0].A, ELL) and not h.levels[0].blocked


def _ae_mats(n=10, parts=8):
    """The AE matrices (~600-800 dofs, the 1024 bucket) of a k-way
    partition of the clamped elasticity problem on hex_mesh(n), c_e =
    10^U(-2, 2): AEs off the clamped face hold six near-zero rigid-body
    modes."""
    from saamge_tpu_torch import api
    from saamge_tpu_torch.fem import assemble
    from saamge_tpu_torch.fem.mesh import hex_mesh
    from saamge_tpu_torch.setup.elmat import GeometricProvider
    from saamge_tpu_torch.topology import part
    mesh = hex_mesh(n)
    ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
    ess[0] = 1
    A, _, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=q.coefficients(n, CONTRAST, 7), ess_attr_marker=ess,
        elasticity=True)
    p = np.asarray(part.partition_kway(mesh.elem_to_elem(), None, parts))
    rels = api.geometric_partitioning(
        A, mesh, api.bdr_dof_flags(mesh, ess, vdim=3), parts, vdim=3,
        partitioning=p)
    return GeometricProvider(rels, A, em).build_all_AE_stiff()


def test_loose_filtered_pairs_are_resolved(monkeypatch):
    """The f32 filter leaves the pairs of elasticity AEs at residuals up
    to ~4e-5 against a theta of 1e-4; the guard of ops/batched_eig.py
    re-solves those AEs exactly, so every AE's B-projector is the host
    Eigensolver's to 1e-5 of its largest entry (filtered pairs that pass
    sit at ~1e-6), with the same cut counts.  Without the guard
    (RR_RESIDUAL_TOL infinite) an AE is off by more than 1e-3."""
    from saamge_tpu_torch.ops import batched_eig as be
    from saamge_tpu_torch.setup.spectral import Eigensolver
    mats, theta = _ae_mats(), 1e-4
    host = [Eigensolver(use_truncated=False).solve(m, theta) for m in mats]

    def projector_errors(routes):
        cut, _, _ = be.bucket_spectral_cut(mats, 1024, theta,
                                           dtype=torch.float32,
                                           device="cpu", routes=routes)
        out = []
        for (X, _, bd), Xd in zip(host, cut):
            assert X.shape == Xd.shape
            Ph, Pd = X @ X.T * bd[None], Xd @ Xd.T * bd[None]
            out.append(float(np.abs(Pd - Ph).max() / np.abs(Ph).max()))
        return out

    routes = {}
    assert max(projector_errors(routes)) < 1e-5
    monkeypatch.setattr(be, "RR_RESIDUAL_TOL", np.inf)
    loose = {}
    assert max(projector_errors(loose)) > 1e-3
    assert routes["filter"] == loose["filter"] == len(mats)
    assert routes["host_resolve"] > loose["host_resolve"]
