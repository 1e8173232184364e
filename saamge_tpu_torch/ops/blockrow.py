"""Block-row device format for coarse Galerkin operators and tentative
restrictions.

Port of saamge_tpu/ops/blockrow.py.  Coarse dofs are numbered
MIS-contiguously, and all rows of one MIS share one column set, so each
row group is stored densely over its column union:

    x_g = x[col_union_g]          (one small gather per block row)
    y_g = Block_g @ x_g           (batched dense product)

Blocks are bucketed by padded (rows, cols) shape exactly as the JAX
module does (rows to multiples of 8, columns to multiples of 16); the
converter and the bucket products read the buckets.  The JAX package
runs the products as einsum/take (no Pallas); so do ``bucket_matvec``
and ``bucket_rmatvec`` here.

Each ``BlockRow`` also packs itself, at construction, for the
hand-written kernel of csrc/blockrow.cu (which replaces no TPU kernel:
it fuses the gather, the small dense product and the row write, or the
column write of the transpose, into one launch).  The packing keeps each
group's real rows and columns only, values back to back row-major,
int32 column indices and a descriptor a group (first row, rows,
columns, value offset, column offset), groups longest first.  One pass
in four modes:

    spmv       y = A x
    residual   y = b - A x
    root       y = x + (dinv * (b - A x)) / tau
    transpose  y = A^T x    (the prolongator; column sets must be disjoint)

``blockrow`` dispatches: CPU tensors run ``blockrow_plain`` (the packing
walked in the kernel's order: the executable spec), f32 CUDA tensors
launch the kernel, other CUDA dtypes run the bucket products.  The
counters ``blockrow.kernel`` (and ``blockrow.kernel.<mode>``) and
``blockrow.plain`` of utils/logging.TIMERS count the launches and the
plain-route calls."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.utils.logging import TIMERS

MODES = {"spmv": 0, "residual": 1, "root": 2, "transpose": 3}
LANES = 32          # a warp: lane l sums the columns c = l (mod LANES)


def _pack(buckets, gather_rows, shape):
    """(values, int32 columns, int32 (G, 5) descriptors, int32 columns no
    group covers, whether the groups' column sets are disjoint) of the
    buckets' real rows and columns, groups longest (rows x columns)
    first.  A group's real rows are those ``gather_rows`` points at,
    ``row0 + r`` for r = 0 .. nr - 1; its real columns the leading
    entries of ``colidx`` below the zero slot m."""
    n, m = shape
    rows = gather_rows.detach().cpu().numpy().astype(np.int64)
    sizes = [int(blocks.shape[0]) * int(blocks.shape[1])
             for blocks, _, _ in buckets]
    base = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    if rows.shape != (n,) or (n and not 0 <= rows.min() <= rows.max()
                              < base[-1]):
        raise ValueError(f"gather_rows of shape {rows.shape} does not map "
                         f"{n} rows into {base[-1]} bucket rows")
    which = np.searchsorted(base, rows, side="right") - 1
    vals, cols, desc = [], [], []
    for i, (blocks, colidx, row0) in enumerate(buckets):
        blocks = blocks.detach().cpu().numpy()
        colidx = colidx.detach().cpu().numpy().astype(np.int64)
        row0 = row0.detach().cpu().numpy().astype(np.int64)
        B, rpad, cpad = blocks.shape
        mine = np.nonzero(which == i)[0]
        k, r = np.divmod(rows[mine] - base[i], rpad)
        if not np.array_equal(mine, row0[k] + r):
            raise ValueError(f"bucket {i}: a row is not its block's row0 "
                             "plus its slot")
        nr = np.bincount(k, minlength=B)
        if np.any(r >= nr[k]):
            raise ValueError(f"bucket {i}: a block's rows are not its "
                             "leading slots")
        real = (colidx >= 0) & (colidx < m)
        nc = real.sum(1)
        if not np.array_equal(real, np.arange(cpad)[None] < nc[:, None]):
            raise ValueError(f"bucket {i}: padding columns before real ones")
        keep = nr > 0
        mask = ((np.arange(rpad)[None, :, None] < nr[:, None, None])
                & (np.arange(cpad)[None, None, :] < nc[:, None, None]))
        vals.append(blocks[keep][mask[keep]])
        cols.append(colidx[keep][real[keep]])
        desc.append(np.stack([row0[keep], nr[keep], nc[keep]], 1))
    v = np.concatenate(vals + [np.zeros(0)])
    c = np.concatenate(cols + [np.zeros(0, np.int64)])
    desc = np.concatenate(desc + [np.zeros((0, 3), np.int64)])
    length = desc[:, 1] * desc[:, 2]
    order = np.argsort(-length, kind="stable")
    vstart = np.concatenate([[0], np.cumsum(length)])
    cstart = np.concatenate([[0], np.cumsum(desc[:, 2])])
    desc = desc[order]
    voff = np.concatenate([[0], np.cumsum(length[order])])
    coff = np.concatenate([[0], np.cumsum(desc[:, 2])])
    v = v[np.repeat(vstart[order] - voff[:-1], length[order])
          + np.arange(voff[-1])]
    c = c[np.repeat(cstart[order] - coff[:-1], desc[:, 2])
          + np.arange(coff[-1])]
    if max(voff[-1], coff[-1], n, m) >= 2 ** 31:
        raise ValueError("the packing exceeds 32-bit offsets")
    desc = np.concatenate([desc, voff[:-1, None], coff[:-1, None]], 1)
    disjoint = np.unique(c).size == c.size
    return (v, c.astype(np.int32), desc.astype(np.int32),
            np.setdiff1d(np.arange(m), c).astype(np.int32), disjoint)


class BlockRow(torch.nn.Module):
    """Bucket i holds buffers ``blocks{i}`` (B, r, c), ``colidx{i}``
    (B, c) with padding pointing at the zero slot m, and ``row0{i}``
    (B,) the first row of each block; ``gather_rows`` (n,) is the flat
    position of row i's value in the concatenated bucket outputs.

    The kernel's packing (see the module docstring) is in the buffers
    ``packed_vals``, ``packed_cols``, ``packed_desc`` (G, 5): row0, nr,
    nc, value offset, column offset) and ``uncovered_cols`` (the
    columns no group has, which the transpose writes as 0); ``disjoint``
    says whether the groups' column sets are disjoint."""

    def __init__(self, buckets, gather_rows: torch.Tensor, shape):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.nbuckets = len(buckets)
        for i, (blocks, colidx, row0) in enumerate(buckets):
            self.register_buffer(f"blocks{i}", blocks)
            self.register_buffer(f"colidx{i}", colidx)
            self.register_buffer(f"row0{i}", row0)
        self.register_buffer("gather_rows", gather_rows)
        vals, cols, desc, uncovered, self.disjoint = _pack(
            buckets, gather_rows, self.shape)
        dev = gather_rows.device
        dtype = buckets[0][0].dtype if buckets else torch.float32
        self.register_buffer("packed_vals",
                             torch.as_tensor(vals).to(dtype).to(dev))
        for name, a in (("packed_cols", cols), ("packed_desc", desc),
                        ("uncovered_cols", uncovered)):
            self.register_buffer(name, torch.as_tensor(a).to(dev))
        self.max_rows = int(desc[:, 1].max()) if len(desc) else 0
        self.max_cols = int(desc[:, 2].max()) if len(desc) else 0

    def buckets(self):
        for i in range(self.nbuckets):
            yield (getattr(self, f"blocks{i}"), getattr(self, f"colidx{i}"),
                   getattr(self, f"row0{i}"))

    @staticmethod
    def from_csr(A: sp.spmatrix, group_offsets: np.ndarray,
                 dtype=torch.float32) -> "BlockRow":
        """group_offsets: (G+1,) row-group boundaries (rows of one group
        are contiguous and share their column set by construction)."""
        A = A.tocsr()
        n, m = A.shape
        if group_offsets[0] != 0 or group_offsets[-1] != n:
            raise ValueError(f"group offsets span [{group_offsets[0]}, "
                             f"{group_offsets[-1]}], the matrix {n} rows")
        groups = {}
        for g in range(len(group_offsets) - 1):
            r0, r1 = int(group_offsets[g]), int(group_offsets[g + 1])
            if r1 == r0:
                continue
            sub = A[r0:r1]
            cols = np.unique(sub.indices)
            dense = np.asarray(sub[:, cols].todense())
            key = (-(-(r1 - r0) // 8) * 8, -(-max(len(cols), 1) // 16) * 16)
            groups.setdefault(key, []).append((r0, r1 - r0, cols, dense))
        buckets = []
        flat_pos = np.zeros(n, dtype=np.int64)
        flat_base = 0
        for (rpad, cpad), items in sorted(groups.items()):
            B = len(items)
            blocks = np.zeros((B, rpad, cpad))
            colidx = np.full((B, cpad), m, dtype=np.int64)   # zero slot
            row0 = np.zeros(B, dtype=np.int64)
            for k, (r0, nr, cols, dense) in enumerate(items):
                blocks[k, :nr, :len(cols)] = dense
                colidx[k, :len(cols)] = cols
                row0[k] = r0
                flat_pos[r0:r0 + nr] = flat_base + k * rpad + np.arange(nr)
            flat_base += B * rpad
            buckets.append((torch.as_tensor(blocks).to(dtype),
                            torch.as_tensor(colidx), torch.as_tensor(row0)))
        return BlockRow(buckets, torch.as_tensor(flat_pos), (n, m))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return blockrow(self, x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T y; with MIS-blocked tentative restrictions this is the
        prolongator application."""
        return blockrow(self, y, "transpose")

    def bucket_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x as the JAX package computes it: a gather, a batched
        product per bucket and a row gather (plain torch)."""
        xp = torch.cat([x, x.new_zeros(1)])
        flat = torch.cat([torch.einsum("brc,bc->br", blocks, xp[colidx])
                          .reshape(-1)
                          for blocks, colidx, _ in self.buckets()])
        return flat[self.gather_rows]

    def bucket_rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y on the bucket storage: per block, gather the
        (contiguous) rows of y, contract with the transposed block and
        add into the column positions (plain torch)."""
        n, m = self.shape
        out = y.new_zeros(m + 1)                       # + zero slot
        yp = torch.cat([y, y.new_zeros(1)])
        for blocks, colidx, row0 in self.buckets():
            ridx = row0[:, None] + torch.arange(blocks.shape[1],
                                                device=y.device)[None, :]
            ridx = torch.where(ridx < n, ridx, n)      # pad rows -> 0
            xg = torch.einsum("brc,br->bc", blocks, yp[ridx])
            out.index_add_(0, colidx.reshape(-1), xg.reshape(-1))
        return out[:m]


class TransposedBlockRow(torch.nn.Module):
    """A^T view sharing the block storage (prolongator = restriction^T).
    Raises unless the base's column sets are disjoint: the transpose
    writes each column from one group."""

    def __init__(self, base: BlockRow):
        super().__init__()
        if not base.disjoint:
            raise ValueError("the block rows' column sets overlap; the "
                             "transpose needs disjoint ones")
        self.base = base

    @property
    def shape(self):
        n, m = self.base.shape
        return (m, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.rmatvec(x)


def _epilogue(ax, x, mode, b, dinv, tau):
    if mode == "residual":
        return b - ax
    if mode == "root":
        return x + (dinv * (b - ax)) / torch.tensor(tau, dtype=ax.dtype,
                                                    device=ax.device)
    return ax


def blockrow_plain(M: BlockRow, x, mode="spmv", b=None, dinv=None,
                   tau: float = 1.0) -> torch.Tensor:
    """One pass in ``mode`` on the packing, in the kernel's order (plain
    torch): lane l of a group's warp sums its columns c = l, l + 32, ...
    in turn, and the 32 lane sums are added by the warp's xor butterfly;
    the transpose sums a column's rows in turn.  Each product is rounded
    before its sum, as the kernel does."""
    n, m = M.shape
    d = M.packed_desc.long()
    row0, nr, nc, voff, coff = d.unbind(1)
    length = nr * nc
    total = int(M.packed_vals.shape[0])
    g = torch.repeat_interleave(torch.arange(len(d), device=d.device),
                                length)
    k = torch.arange(total, device=d.device) - voff[g]
    r = torch.div(k, nc[g], rounding_mode="floor")
    c = k - r * nc[g]
    slot = coff[g] + c                       # position in packed_cols
    cols = M.packed_cols.long()
    if mode == "transpose":
        prod = M.packed_vals * x[row0[g] + r]
        acc = prod.new_zeros(cols.shape[0])
        for j in range(M.max_rows):
            sel = r == j
            acc[slot[sel]] = acc[slot[sel]] + prod[sel]
        y = prod.new_zeros(m)
        y[cols] = acc
        return y
    prod = M.packed_vals * x[cols[slot]]
    row, lane = row0[g] + r, c % LANES
    chunk = torch.div(c, LANES, rounding_mode="floor")
    acc = prod.new_zeros(n, LANES)
    for j in range(-(-M.max_cols // LANES)):
        sel = chunk == j
        acc[row[sel], lane[sel]] = acc[row[sel], lane[sel]] + prod[sel]
    lanes = torch.arange(LANES, device=d.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return _epilogue(acc[:, 0], x, mode, b, dinv, tau)


def _bucket_product(M: BlockRow, x, mode, b, dinv, tau):
    if mode == "transpose":
        return M.bucket_rmatvec(x)
    return _epilogue(M.bucket_matvec(x), x, mode, b, dinv, tau)


def blockrow(M: BlockRow, x, mode="spmv", b=None, dinv=None,
             tau: float = 1.0) -> torch.Tensor:
    """One pass of ``M`` in ``mode`` ('spmv', 'residual', 'root' or
    'transpose'): the kernel for f32 CUDA tensors, the bucket products
    for other CUDA dtypes, ``blockrow_plain`` for CPU tensors."""
    if mode not in MODES:
        raise ValueError(mode)
    n, m = M.shape
    if mode == "transpose" and not M.disjoint:
        raise ValueError("the transpose needs disjoint column sets")
    if mode in ("residual", "root") and n != m:
        raise ValueError(f"{mode} of a {n} x {m} operator")
    vecs = {"x": x}
    if mode in ("residual", "root"):
        vecs["b"] = b
    if mode == "root":
        vecs["dinv"] = dinv
    if not is_cuda(M.packed_vals, *vecs.values()):
        TIMERS.count("blockrow.plain")
        return blockrow_plain(M, x, mode, b, dinv, tau)
    if any(t.dtype != torch.float32
           for t in (M.packed_vals, *vecs.values())):
        TIMERS.count("blockrow.plain")
        return _bucket_product(M, x, mode, b, dinv, tau)
    nin, nout = (n, m) if mode == "transpose" else (m, n)
    check(M.packed_cols, "cols", torch.int32, (M.packed_cols.shape[0],))
    check(M.packed_desc, "desc", torch.int32, (M.packed_desc.shape[0], 5))
    for name, v in vecs.items():
        check(v, name, torch.float32, (nin if name == "x" else nout,))
    lib = _build.load()
    y = torch.empty(nout, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.saamge_blockrow(
            MODES[mode], M.packed_vals.data_ptr(), M.packed_cols.data_ptr(),
            M.packed_desc.data_ptr(), M.packed_desc.shape[0],
            M.uncovered_cols.data_ptr(), M.uncovered_cols.shape[0],
            x.data_ptr(), b.data_ptr() if "b" in vecs else None,
            dinv.data_ptr() if "dinv" in vecs else None, float(tau),
            y.data_ptr(), _build.stream_ptr(x.device))
    _build.check_launch(lib, code, "blockrow")
    TIMERS.count("blockrow.kernel")
    TIMERS.count("blockrow.kernel." + mode)
    return y
