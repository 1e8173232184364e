"""Tests of the port's CUDA kernels that need the card (no JAX here: the
machine with the card has none).  Each skips without a card; run them
there with ``python -m pytest --noconftest -m card
tests/test_torch_card.py`` (tests/conftest.py imports JAX)."""

import numpy as np
import pytest
import torch

from saamge_tpu_torch.ops.midmv import midmv, midmv_plain, pack_mid


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _random_mid(bricks, bs, seed):
    """A compact packing with blocks of 1-6 random rows and columns at
    every brick and offset of the 27, and three vectors."""
    NB = int(np.prod(bricks))
    doffs = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1))
    rng = np.random.default_rng(seed)
    coo = []
    for p in range(NB):
        for k in range(len(doffs)):
            rows = rng.choice(bs, rng.integers(1, 7), replace=False)
            cols = rng.choice(bs, rng.integers(1, 7), replace=False)
            r, c = np.meshgrid(rows, cols, indexing="ij")
            coo.append((np.full(r.size, k), np.full(r.size, p), r.ravel(),
                        c.ravel()))
    k, p, s1, s2 = (np.concatenate(a) for a in zip(*coo))
    vals = torch.as_tensor(rng.standard_normal(len(k)),
                           dtype=torch.float32).to(torch.bfloat16)
    packing = pack_mid(k, p, s1, s2, vals, doffs, bricks, bs)
    x, b, dinv = (torch.as_tensor(rng.standard_normal(bs * NB),
                                  dtype=torch.float32) for _ in range(3))
    return packing, doffs, x, b, dinv


@pytest.mark.card
@pytest.mark.parametrize("bricks,bs", [((12, 12, 12), 20), ((5, 3, 7), 40)])
def test_midmv_kernel_repeats_bit_equal(card, bricks, bs):
    """Two launches of csrc/midmv.cu in each mode give the same bits (a
    fixed order of sums, no atomics), within 1e-5 of the plain version;
    one mask word (bs 20) and two (bs 40)."""
    (vals, index), doffs, x, b, dinv = _random_mid(bricks, bs, 20)
    args = dict(b=b, dinv=dinv, inv_tau=0.7)
    for mode in ("spmv", "residual", "root"):
        kw = {k: v for k, v in args.items()
              if mode == "root" or (mode == "residual" and k == "b")}
        ref = midmv_plain(vals, index, doffs, bricks, bs, x, mode, **kw)
        on = [t.to(card) for t in (vals, index, x)]
        kw_on = {k: (v.to(card) if torch.is_tensor(v) else v)
                 for k, v in kw.items()}
        y1 = midmv(*on[:2], doffs, bricks, bs, on[2], mode, **kw_on)
        y2 = midmv(*on[:2], doffs, bricks, bs, on[2], mode, **kw_on)
        torch.cuda.synchronize(card)
        assert torch.equal(y1, y2), mode
        err = float((y1.cpu() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (mode, err)


@pytest.mark.card
@pytest.mark.parametrize("dims,k", [((13, 17, 19), 27), ((5, 7, 11), 7)])
def test_vstencil_kernel_equals_plain(card, dims, k):
    """csrc/vstencil.cu in each mode (the chain with 10 and with 33 roots,
    two launches, and its residual) gives the bits of vstencil_plain on
    the CPU: the same products and sums in the same order, each rounded
    apart."""
    from saamge_tpu_torch.ops.sparse import NodeBlock
    from saamge_tpu_torch.ops.vstencil import vstencil, vstencil_plain
    rng = np.random.default_rng(3)
    X, Y, Z = dims
    offs = sorted({dx * Y * Z + dy * Z + dz for dx in (-1, 0, 1)
                   for dy in (-1, 0, 1) for dz in (-1, 0, 1)})
    offs = sorted(set(offs[:k - 1]) | {0})
    N = X * Y * Z
    vals = rng.uniform(-0.01, 0.01, (len(offs), 3, 3, N))
    vals[offs.index(0)] += np.eye(3)[:, :, None]
    A = NodeBlock(torch.as_tensor(vals, dtype=torch.float32), offs)
    x, b = (A.pad(torch.as_tensor(rng.uniform(-1, 1, A.n),
                                  dtype=torch.float32)) for _ in range(2))
    d = A.pad(torch.as_tensor(rng.uniform(0.5, 1.0, A.n),
                              dtype=torch.float32))
    Ac = NodeBlock(A.vals.to(card), offs)
    for mode, kw in [("spmv", {}), ("residual", dict(bh=b))] + [
            ("chain", dict(bh=b, dinvh=d, inv_taus=tuple(
                float(np.float32(t)) for t in rng.uniform(0.5, 1.5, r)),
                emit_residual=True)) for r in (10, 33)]:
        ref = vstencil_plain(A, mode, x, **kw)
        got = vstencil(Ac, mode, x.to(card), **{
            key: (v.to(card) if torch.is_tensor(v) else v)
            for key, v in kw.items()})
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r), mode


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 367, 700, 1000])
def test_symv_kernel_equals_plain(card, n, dtype):
    """csrc/symv.cu on lower-triangle tiles (one tile, ragged and whole
    tile rows) gives the bits of symv_plain on the CPU: the same products
    and sums in the same order, each rounded apart; two launches repeat
    them, and ``symv.kernel`` counts each product."""
    from saamge_tpu_torch.ops.symv import pack_lower, symv, symv_plain
    from saamge_tpu_torch.utils.logging import TIMERS
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    tiles = pack_lower(torch.as_tensor(M + M.T, dtype=dtype))
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    ref = symv_plain(tiles, x)
    before = TIMERS.counters.get("symv.kernel", 0)
    tc, xc = tiles.to(card), x.to(card)
    y1, y2 = symv(tc, xc), symv(tc, xc)
    torch.cuda.synchronize(card)
    assert TIMERS.counters["symv.kernel"] - before == 2
    assert torch.equal(y1, y2)
    assert torch.equal(y1.cpu(), ref)
