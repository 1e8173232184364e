"""The product y = A x of a symmetric matrix stored as the TILE x TILE
tiles of its lower triangle: the general path's coarsest correction, the
explicit inverse of its SPD coarsest operator applied to the coarsest
residual (solve/compiled.py coarse_solve).

``pack_lower`` stores tile (I, J) for J <= I at I (I + 1) / 2 + J, tiles
row-major by I then J and row-major inside, diagonal tiles whole, zero
past n in the ragged last tile row and column: nt (nt + 1) / 2 tiles,
nt = ceil(n / TILE), about half the dense matrix.

The wrapper ``symv`` launches the hand-written kernel (csrc/symv.cu:
one block a tile reads it once for A_IJ x_J and, off the diagonal,
A_IJ^T x_I, into a workspace slot each; a second launch sums each row's
slots in a fixed order) for CUDA tensors, f32 or f64; for CPU
tensors it runs ``symv_plain``, the same products and sums in the same
order in plain torch, which gives the kernel's bits.  The counters
``symv.kernel`` and ``symv.plain`` of utils/logging.TIMERS count the
products launched and those that take the plain route; ``symv.bytes``
adds the bytes of each packing that ``pack_lower`` builds."""

from __future__ import annotations

import torch

from saamge_tpu_torch._device import check, is_cuda
from saamge_tpu_torch.ops import _build
from saamge_tpu_torch.utils.logging import TIMERS

TILE = 128          # SYMV_TILE of csrc/symv.cu
LANES = 32          # lane l of a warp holds the tile's columns 4l .. 4l + 3
WARPS = 8           # warp w holds the tile's rows w, w + WARPS, ...


def tile_rows(n: int) -> int:
    """nt, the tile rows (and columns) of an n x n packing."""
    return -(-n // TILE)


def pack_lower(M: torch.Tensor) -> torch.Tensor:
    """The lower-triangle tiles of the symmetric n x n ``M``, on its
    device and in its dtype: (nt (nt + 1) / 2, TILE, TILE).  A diagonal
    tile takes its upper triangle from its lower one, so that the
    product sees an exactly symmetric matrix.  Adds the tiles' bytes to
    ``symv.bytes``."""
    n = M.shape[0]
    if M.shape != (n, n) or n < 1:
        raise ValueError(f"expected a square matrix, got {tuple(M.shape)}")
    nt = tile_rows(n)
    pad = nt * TILE - n
    Mp = torch.nn.functional.pad(M, (0, pad, 0, pad))
    I, J = torch.tril_indices(nt, nt, device=M.device)
    tiles = Mp.view(nt, TILE, nt, TILE).permute(0, 2, 1, 3)[I, J] \
        .contiguous()
    del Mp
    diag = (I * (I + 1)) // 2 + I
    low = torch.tril(tiles[diag])
    tiles[diag] = low + torch.tril(low, -1).mT
    TIMERS.count("symv.bytes", tiles.numel() * tiles.element_size())
    return tiles


def symv_plain(tiles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``symv`` in plain torch (any device, f32 or f64), in the kernel's
    order: each product rounded, a lane's four columns summed in order
    and the 32 lanes by the warp's butterfly (halves added, 32 -> 1);
    the column sums a warp's 16 rows in order, then the 8 warps in
    order; each output row's slots J = w, w + WARPS, ... in order from
    zero for w = 0 .. WARPS - 1, then those WARPS sums in order.  One
    tile row at a time, so that no temporary is larger than a tile
    row."""
    n = x.shape[0]
    nt = tile_rows(n)
    xs = torch.nn.functional.pad(x, (0, nt * TILE - n)).view(nt, TILE)
    work = torch.empty(nt, nt, TILE, dtype=x.dtype, device=x.device)
    for i in range(nt):
        row = tiles[i * (i + 1) // 2:(i + 1) * (i + 2) // 2]
        # u = A_IJ x_J: (J, rows, lanes, 4) products
        p = (row * xs[:i + 1, None, :]).view(i + 1, TILE, LANES, 4)
        u = p[..., 0]
        for c in range(1, 4):
            u = u + p[..., c]
        while u.shape[-1] > 1:
            h = u.shape[-1] // 2
            u = u[..., :h] + u[..., h:]
        work[i, :i + 1] = u[..., 0]
        if i == 0:
            continue
        # v = A_IJ^T x_I off the diagonal: row w + WARPS k of a tile is
        # (k, w)
        q = (row[:i] * xs[i][:, None]).view(i, TILE // WARPS, WARPS, TILE)
        acc = q[:, 0]
        for k in range(1, TILE // WARPS):
            acc = acc + q[:, k]
        v = acc[:, 0]
        for w in range(1, WARPS):
            v = v + acc[:, w]
        work[:i, i] = v
    parts = []
    for w in range(WARPS):
        s = torch.zeros(nt, TILE, dtype=x.dtype, device=x.device)
        for j in range(w, nt, WARPS):
            s = s + work[:, j]
        parts.append(s)
    y = parts[0]
    for s in parts[1:]:
        y = y + s
    return y.reshape(-1)[:n]


def symv(tiles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for A packed by ``pack_lower`` (n = x's length): the
    kernel for CUDA tensors, ``symv_plain`` for CPU tensors."""
    if not is_cuda(tiles, x):
        TIMERS.count("symv.plain")
        return symv_plain(tiles, x)
    n = x.shape[0]
    nt = tile_rows(n)
    check(x, "x", (torch.float32, torch.float64), (n,))
    check(tiles, "tiles", x.dtype, (nt * (nt + 1) // 2, TILE, TILE))
    if tiles.data_ptr() % 16:
        raise ValueError("tiles: not 16-byte aligned")
    lib = _build.load()
    work = torch.empty(nt * nt * TILE, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.saamge_symv(int(x.dtype == torch.float64),
                               tiles.data_ptr(), x.data_ptr(), n,
                               work.data_ptr(), y.data_ptr(),
                               _build.stream_ptr(x.device))
    _build.check_launch(lib, code, "symv")
    TIMERS.count("symv.kernel")
    return y
