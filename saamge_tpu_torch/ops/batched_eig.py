"""Batched device eigensolves for the setup phase.

The port of saamge_tpu/ops/batched_eig.py.  The reference's setup hot
loop (interp_compute_vectors, interp.cpp:342) solves one dense
generalized eigenproblem ``A_T x = lambda B_T x`` per agglomerate,
serially, via LAPACK dsygv/dsygvx (xpacks.cpp:224-315), with B_T the
weighted-l1 smoother diagonal.  The per-AE problems are independent, so
they become batched padded dense eigensolves per size bucket:

  - AE matrices are bucketed by padded size (next power of two >=
    ``bucket_multiple``); each bucket is stacked into (B, nmax, nmax).
  - Padded rows/cols are zeroed and the padded diagonal is set to 1
    AFTER the weighted-l1 scaling, so every padding eigenvalue is
    exactly 1.0.  Spectral cuts use theta < 1, so padding eigenpairs are
    never selected.
  - Since B is diagonal, the generalized problem reduces to the standard
    symmetric eigenproblem of ``M = B^-1/2 A B^-1/2`` and eigenvectors map
    back as ``x = B^-1/2 y`` -- what the host Eigensolver does, batched.

The routing is the JAX function's, so that the same AE meets the same
solver on both sides: sparse AEs and AEs above ``device_max_n`` go to
the host, and so do small buckets (``len * nmax^3 < 2e10``); f32
buckets with ``nmax >= 256`` take the Chebyshev filter
(ops/filtered_eig.py) with an f64 Rayleigh-Ritz on the host, the rest a
batched ``torch.linalg.eigh`` on the device.  A bucket is solved in
chunks of ``chunk`` AEs (the JAX function stacks it whole in f64 on the
host, ~17 GB an array for 1,953 AEs of the 1024 bucket); the filter's
start rows come from one generator per bucket, drawn chunk after chunk,
so that each AE gets the rows of the whole-bucket draw.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as ssp
import torch

from saamge_tpu_torch.ops.filtered_eig import (FILTER_RESIDUAL_TOL,
                                               batched_smallest_eigs)
from saamge_tpu_torch.utils.logging import TIMERS

__all__ = ["batched_spectral_cut", "batched_weighted_l1",
           "bucket_spectral_cut", "padded_eigh_stack"]


def _bucket_size(n: int, multiple: int) -> int:
    """Pad to the next power of two (>= multiple): few distinct shapes
    (the JAX function's compile-count rule, kept so that the buckets,
    and with them the routes, are the same)."""
    m = max(multiple, 16)
    while m < n:
        m *= 2
    return m


def _eigh_batched(Mstack: torch.Tensor):
    """Batched standard sym-eig; Mstack is the pre-scaled, pre-padded
    (B, nmax, nmax) stack (symmetric; padding block = identity)."""
    return torch.linalg.eigh(0.5 * (Mstack + Mstack.transpose(1, 2)))


def batched_weighted_l1(Astack: np.ndarray) -> np.ndarray:
    """Batched weighted-l1 smoother diagonals (host convenience)."""
    diag = np.diagonal(Astack, axis1=1, axis2=2)
    s = np.sqrt(diag)
    return np.einsum("bij,bj->bi", np.abs(Astack), 1.0 / s) * s


def padded_eigh_stack(mats: Sequence[np.ndarray], nmax: int,
                      dtype=np.float64):
    """Stack ragged square matrices into a zero-padded (B, nmax, nmax)."""
    B = len(mats)
    out = np.zeros((B, nmax, nmax), dtype=dtype)
    sizes = np.empty(B, dtype=np.int32)
    for k, m in enumerate(mats):
        n = m.shape[0]
        sizes[k] = n
        out[k, :n, :n] = m
    return out, sizes


def count_route(routes: Optional[dict], key: str, k: int) -> None:
    """Add k AEs to a route's count (``routes`` may be None) and to the
    counter ``setup.eig_route.<key>`` of utils/logging.TIMERS."""
    TIMERS.count("setup.eig_route." + key, k)
    if routes is not None:
        routes[key] = routes.get(key, 0) + k


def _scaled_stack(mats, nmax: int):
    """Host f64: weighted-l1 diagonals and the B^{-1/2} A B^{-1/2}
    scaling, identity padding.  Returns (M, sizes, bdiag, dhalf)."""
    stack, sizes = padded_eigh_stack(mats, nmax, dtype=np.float64)
    B = len(mats)
    bdiag = np.ones((B, nmax))
    dhalf = np.ones((B, nmax))
    M = stack                                 # scaled in place
    for k in range(B):
        n = int(sizes[k])
        bk = batched_weighted_l1(stack[k:k + 1, :n, :n])[0]
        bdiag[k, :n] = bk
        dh = 1.0 / np.sqrt(bk)
        dhalf[k, :n] = dh
        M[k, :n, :n] = dh[:, None] * stack[k, :n, :n] * dh[None, :]
        M[k, np.arange(n, nmax), np.arange(n, nmax)] = 1.0
    return M, sizes, bdiag, dhalf


def _lowest_pairs(Mk: np.ndarray, k: int, theta: float):
    """The exact lowest pairs of Mk (f64 LAPACK): the lowest k (subset
    mode), or all of them when the theta cut may go beyond k -- the
    pairs that a full solve gives the cut."""
    lam, Z = sla.eigh(Mk, subset_by_index=[0, min(k, Mk.shape[0]) - 1])
    if lam[-1] <= theta:
        lam, Z = sla.eigh(Mk)
    return lam, Z


def _solve_chunk(M: np.ndarray, sizes, theta, dtype, device, rng, routes):
    """The device solve of one chunk of a bucket (M: the host f64 scaled
    stack).  Returns, per AE, the computed eigenvalues ascending and
    the matching scaled-space eigenvectors (n, ncomp), f64: every pair
    the theta cut can take, and the one after it."""
    B, nmax, _ = M.shape
    M_dev = torch.as_tensor(M, dtype=dtype).to(device)
    out = []
    if nmax >= 256 and dtype == torch.float32:
        # large matrices: Chebyshev-filtered subspace solver (batched
        # matmul) + f64 Rayleigh-Ritz against the host operators.  Only
        # the lowest mk pairs exist afterwards -- enough for any theta
        # cut this path serves (theta << 1).
        mk = min(64, nmax)
        _, Xf_d, f_res = batched_smallest_eigs(M_dev, mk, rng=rng)
        del M_dev
        Xf = Xf_d.to("cpu", torch.float64).numpy()
        del Xf_d
        # filtered subspace failed to converge (clustered / borderline
        # spectrum, a failed factorization): exact host solves for
        # these, on a thread pool (LAPACK releases the GIL)
        flagged = [k for k in range(B)
                   if not (np.isfinite(f_res[k]).all()
                           and f_res[k].max() <= FILTER_RESIDUAL_TOL)]
        workers = min(os.cpu_count() or 1, 16)
        with TIMERS.phase("setup.local_eigensolves.resolve"), \
                cf.ThreadPoolExecutor(workers) as ex:
            exact = dict(zip(flagged, ex.map(
                lambda k: _lowest_pairs(M[k, :sizes[k], :sizes[k]], mk,
                                        theta), flagged)))
        for k in range(B):
            if k in exact:
                out.append(exact[k])
                continue
            n = int(sizes[k])
            Mk = M[k, :n, :n]
            Xk = Xf[k][:n]
            # f64 Rayleigh-Ritz against the host-built scaled operator M
            W = Xk.T @ (Mk @ Xk)
            G = Xk.T @ Xk
            # near-dependent filtered vectors make G singular; the
            # trace-scaled ridge matches filtered_eig's internal RR
            G = G + 1e-12 * np.trace(G) / G.shape[0] * np.eye(G.shape[0])
            lam, Z = sla.eigh(0.5 * (W + W.T), 0.5 * (G + G.T))
            out.append((lam, Xk @ Z))
        count_route(routes, "filter", B)
        count_route(routes, "host_resolve", len(flagged))
    else:
        evals_d, Y_d = _eigh_batched(M_dev)
        del M_dev
        evals = evals_d.to("cpu", torch.float64).numpy()
        Y = Y_d.to("cpu", torch.float64).numpy()
        for k in range(B):
            n = int(sizes[k])
            out.append((evals[k], Y[k][:n, :n]))
        count_route(routes, "eigh", B)
    return out


def bucket_spectral_cut(mats: Sequence[np.ndarray], nmax: int,
                        theta: float, use_truncated: bool = False,
                        truncated_threshold: int = 64,
                        max_vectors: int = 10, dtype=torch.float32,
                        device="cuda", chunk: int = 512,
                        routes: Optional[dict] = None):
    """The device solve of one size bucket (every matrix at most
    ``nmax``), with batched_spectral_cut's theta-cut semantics: f32 with
    ``nmax >= 256`` takes the filter, anything else ``eigh``.  Returns
    (cut_evects, skipped, bdiags) over ``mats``."""
    nae = len(mats)
    cut: List[Optional[np.ndarray]] = [None] * nae
    skipped: List[float] = [0.0] * nae
    bdiags: List[Optional[np.ndarray]] = [None] * nae
    rng = np.random.default_rng(0)
    for c0 in range(0, nae, chunk):
        cidx = range(c0, min(c0 + chunk, nae))
        M, sizes, bdiag, dhalf = _scaled_stack([mats[i] for i in cidx],
                                               nmax)
        pairs = _solve_chunk(M, sizes, theta, dtype, device, rng, routes)
        del M
        for k, i in enumerate(cidx):
            n = int(sizes[k])
            ev, Y = pairs[k]
            nc = min(len(ev), n)
            truncated = use_truncated and n > truncated_threshold
            if truncated:
                kk = min(max_vectors, n, nc)
                got = 1 + int((ev[1:kk] < theta).sum())
                m = got
                skip = float(ev[kk - 1] if got == kk else max(ev[got], 0.0))
            else:
                m = max(int(np.searchsorted(ev, theta, side="right")), 1)
                m = min(m, nc)
                # skip = first eigenvalue beyond the cut; clamp to the
                # last COMPUTED value
                skip = float(ev[m] if m < nc else ev[nc - 1])
            # back to generalized eigenvectors: x = B^{-1/2} y (host, f64)
            cut[i] = dhalf[k, :n, None] * Y[:, :m]
            skipped[i] = skip
            bdiags[i] = bdiag[k, :n].copy()
    return cut, skipped, bdiags


def batched_spectral_cut(
        mats: Sequence[np.ndarray], theta: float,
        bucket_multiple: int = 32,
        use_truncated: bool = False,
        truncated_threshold: int = 64,
        max_vectors: int = 10,
        dtype=torch.float32,
        device_max_n: int = 1024,
        device="cuda", routes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[float], List[np.ndarray]]:
    """Device-batched replacement for per-AE Eigensolver.solve loops, on
    ``device``.

    Returns (cut_evects, skipped, bdiags) -- lists over AEs with the same
    theta-cut semantics as setup.spectral.Eigensolver:
      - direct mode: keep eigenvalues <= theta (at least one);
      - truncated (ARPACK-analog) mode for AEs larger than
        ``truncated_threshold``: at most ``max_vectors`` vectors, kept
        while lambda < theta strictly, at least one.
    ``skipped`` is the smallest eigenvalue not taken (adaptive-theta
    input).  ``dtype`` is the device solve's (torch.float32, the JAX
    default with x64 off; torch.float64 takes ``eigh`` everywhere).
    ``routes``, when given, gains the number of AEs per solver: "host"
    (routed to the host), "filter", "eigh" and "host_resolve"."""
    if not theta < 1.0:
        raise ValueError("theta >= 1 would select padding eigenpairs")
    nae = len(mats)
    buckets: Dict[int, List[int]] = {}
    host_idxs: List[int] = []
    for i, m in enumerate(mats):
        nmax = _bucket_size(max(m.shape[0], 1), bucket_multiple)
        if nmax > device_max_n or ssp.issparse(m):
            # very large AEs (rare: only badly unbalanced or tiny-nparts
            # levels) and sparse-stored AEs go to the host (LAPACK /
            # sparse-LOBPCG ARPACK-analog) path instead
            host_idxs.append(i)
        else:
            buckets.setdefault(nmax, []).append(i)
    # small buckets go to the host outright (the JAX function's rule: a
    # fresh device eigh shape cost a compile there)
    for nmax in [nmax for nmax, idxs in buckets.items()
                 if len(idxs) * nmax ** 3 < 2e10]:
        host_idxs += buckets.pop(nmax)

    cut: List[Optional[np.ndarray]] = [None] * nae
    skipped: List[float] = [0.0] * nae
    bdiags: List[Optional[np.ndarray]] = [None] * nae

    if host_idxs:
        from saamge_tpu_torch.setup.spectral import Eigensolver
        eig = Eigensolver(use_truncated=use_truncated,
                          max_vectors=max_vectors)
        with TIMERS.phase("setup.local_eigensolves.host"):
            for i in sorted(host_idxs):
                cut[i], skipped[i], bdiags[i] = eig.solve(mats[i], theta)
        count_route(routes, "host", len(host_idxs))

    if buckets:
        dev = torch.device(device)
    for nmax, idxs in sorted(buckets.items()):
        out = bucket_spectral_cut(
            [mats[i] for i in idxs], nmax, theta, use_truncated,
            truncated_threshold, max_vectors, dtype, dev, routes=routes)
        for k, i in enumerate(idxs):
            cut[i], skipped[i], bdiags[i] = (o[k] for o in out)
    return cut, skipped, bdiags
