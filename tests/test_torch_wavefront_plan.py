"""The schedule of the sweep kernel (csrc/wavefront.cu), replayed on the
CPU: one level at a time (root r, or the residual as level k + 1), each
computing every row with the plain stencil pass from the buffer the
level before it wrote, through the kernel's two ping-pong buffers and
the residual buffer as ``level_buf`` picks them.  The result must equal
``wavefront_plain`` bit for bit, the last root must land in ``out``, and
no level may write the buffer it reads."""

import numpy as np
import pytest
import torch

from saamge_tpu_torch import flagship_problem
from saamge_tpu_torch.ops.sparse import DIA
from saamge_tpu_torch.ops.stencil import stencil_plain_h
from saamge_tpu_torch.ops.wavefront import wavefront_plain

torch.set_num_threads(1)


def _buf(r, k):
    """The kernel's output buffer of level r (1-based; k + 1 = residual)."""
    if r > k:
        return "res"
    return "out" if (k - r) % 2 == 0 else "tmp"


def replay(A, inv_taus, bh, dinvh, xh, emit_res):
    k = len(inv_taus)
    bufs = {name: torch.full_like(xh, float("nan"))
            for name in ("out", "tmp", "res")}
    bufs["x0"] = xh
    src = "x0"
    for r in range(1, k + int(emit_res) + 1):
        dst = _buf(r, k)
        assert dst != src, f"level {r} writes the buffer {src} it reads"
        if r > k:
            y = stencil_plain_h("residual", A, bufs[src], bh)
        else:
            y = stencil_plain_h("root", A, bufs[src], bh, dinvh,
                                inv_tau=inv_taus[r - 1])
        bufs[dst] = y
        src = dst if r <= k else src
    assert src == "out", f"the last root lands in {src}"
    return (bufs["out"], bufs["res"]) if emit_res else bufs["out"]


def _vecs(n, halo, seed):
    rng = np.random.default_rng(seed)
    x, b = (torch.as_tensor(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    dinv = torch.as_tensor(rng.uniform(0.5, 1.0, n).astype(np.float32))
    pad = lambda v: torch.nn.functional.pad(v, (halo, halo))  # noqa: E731
    return pad(x), pad(b), pad(dinv)


@pytest.fixture(scope="module")
def twin():
    """The n=16 flagship's bf16 smoother twin and its 10 roots."""
    ml, _, _, _ = flagship_problem(n=16, brick=4, supers=(2, 2, 2))
    pd = ml.levels[0].tg_data.poly_data
    A = DIA.from_csr(ml.levels[0].A, torch.float32)
    A = DIA(A.vals.to(torch.bfloat16), A.offsets, A.n)
    taus = [float(np.float32(1.0 / float(t))) for t in np.asarray(pd.roots)]
    return A, taus


def _odd_operator(dims, seed):
    """A random 27-point operator on an odd box grid (rows x-major)."""
    X, Y, Z = dims
    offs = tuple(dx * Y * Z + dy * Z + dz for dx in (-1, 0, 1)
                 for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    n = X * Y * Z
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-0.05, 0.05, (27, n)).astype(np.float32)
    vals[13] = 1.0
    return DIA(torch.as_tensor(vals), offs, n)


def _check(A, taus, emit_res, seed):
    xh, bh, dinvh = _vecs(A.n, A.halo, seed)
    ref = wavefront_plain(A, taus, bh, dinvh, xh, emit_res)
    got = replay(A, taus, bh, dinvh, xh, emit_res)
    if not emit_res:
        ref, got = (ref,), (got,)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("roots", [1, 2, 10])
def test_replay_flagship_twin_equals_plain(twin, roots, emit_res):
    A, taus = twin
    _check(A, taus[:roots], emit_res, roots)


@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("roots", [1, 2, 3, 10])
@pytest.mark.parametrize("dims", [(7, 9, 11), (5, 7, 13)])
def test_replay_odd_sizes_equals_plain(dims, roots, emit_res):
    A = _odd_operator(dims, 3)
    taus = [0.9, 0.6, 1.1, 0.7, 0.8, 1.0, 0.5, 1.2, 0.65, 0.95][:roots]
    _check(A, taus, emit_res, 7)
