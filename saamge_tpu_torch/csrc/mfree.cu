// Kernel 5: the matrix-free Q1 fine operator  y = A x,  y = b - A x,  or the
// smoother root  y = x + dinv (b - A x) / tau,  with the 27 stencil values
// of each row recomputed from the element coefficient field c and the 8x8
// reference element matrix K:
//
//   A[u, u + delta] = sum_{corner(l') - corner(l) = delta} K[l, l'] c(u - corner(l))
//   A x = m * A_full(m * x) + (1 - m) * d * x      (m: free-dof node mask)
//
// as one pass (saamge_mfree) or as a whole smoothing chain, k roots and
// optionally the trailing residual, in one cooperative launch
// (saamge_mfree_chain).
//
// Replaces: saamge_tpu/ops/pallas_mfree.py `_build_mfree` (the Pallas
// kernel behind MatrixFreeQ1.matvec_h / residual_h / root_h; the JAX
// package chains its roots one pass each, saamge_tpu/solve/structured.py
// _smooth_h).
//
// Layout: the flat haloed vectors of stencil.cu (halo = sx + sy + 1 zeros
// on each side, sx = NYn*NZn, sy = NZn).  c is zero on the last node plane
// of each dimension and in the halo, so a tap that wraps to the next grid
// line or leaves the grid meets a zero coefficient and needs no branch.
// c and m are f32 (the PCG operator) or bf16 (the smoother twin), widened
// on load; arithmetic is f32.
//
// Work a node: ~91 FMAs (64 rebuild the 27 values from 8 corner
// coefficients, 27 are taps).  Bytes a node and level: c and m (bf16 in
// the chain), x, b and dinv in, y out.  What bounds it on an H100 depends
// on whether a level's working set stays in the 50 MB L2, and
// ops/mfree.mfree_plan picks one of two routes from the dims on that test:
//   - tiled (the working set exceeds L2; n=192, 193^3 nodes, the capacity
//     cell): ~145 MB a level from device memory, ~48 us at 3 TB/s,
//     against ~20 us of FMAs: bytes.  It takes ~90 us a level;
//   - flat (the working set fits L2 and NZn <= 127; n=96, 97^3 nodes,
//     ~22 MB): issue, ~91 FMAs and 35 shared loads a node at one barrier
//     a step; ~8-11 us a level.
// PERF.md section 6 has the measurements behind both routes.
//
// Tiled route: a block owns a 2D (y, z) tile of ty x tz nodes (z
// contiguous) and marches along x over a chunk of planes; a thread holds
// a run of MFREE_RUN = 2 nodes along z.  Plane p's x*m and c add its taps
// to three outputs at once: the dx = +1 taps of output p - 1 (then its
// epilogue), the dx = 0 taps of output p and the dx = -1 taps of output
// p + 1.  A thread carries its tap sums of outputs p - 1 and p, the centre
// values and its c of plane p - 1 in registers from one step to the next,
// so that only plane p goes through shared memory (18 loads for two
// nodes).  Shared memory holds two slots each of the (ty + 2) x (tz + 2)
// windows of x*m and c, rows of pitch tz + 3 (odd, so that the rows a warp
// reads fall on other banks); the windows do not grow with NZn.  An item
// of planes [i0, i1) takes i1 - i0 + 2 steps: planes i0 - 1 and i1 reach
// one output each.
//
// Flat route: a block owns a range of MFREE_FLAT = 512 consecutive nodes
// of the flat (y, z) plane index and marches along x; shared memory holds
// a ring of four planes of x*m and three of c, each the range plus the
// halo its taps reach (sy + 1 nodes on each side for x*m, below it for c:
// at most 3 values a thread, hence NZn <= 127).  A step computes one
// output plane whole from the ring (35 shared loads a node), so an item
// of planes [i0, i1) takes i1 - i0 steps: where a level is issue-bound
// and an item holds a few planes, this beats the tiled route's two extra
// steps.
//
// Both routes: ops/mfree.mfree_plan picks the tile shape; the planes are
// cut into as many chunks as leave one item (a tile over a chunk) a
// block, and all tiles of a chunk march side by side, so their window
// halos meet in L2.  The block fetches the next plane into registers
// during the compute and stores it a step later: one barrier a step.
//
// Every value is loaded by its flat offset from the node, as the
// one-thread-a-node kernel (mfree_point_kernel, the reference) loads it,
// so a tap past a tile's or the grid's edge meets the same x and the
// same zero c.  Every kernel adds each value's terms from its 8 corner
// coefficients in increasing l just before its tap, and each row's taps
// in offset order (mfree_rows, or mfree_taps / mfree_finish over three
// steps): every pass equals the reference bit for bit, and the chain
// equals its own passes.  Halo rows are written as zeros, so the output
// chains.
//
// TMA is not used: a haloed vector's y stride (sy values: 772 B in f32
// and 386 B in bf16 at NZn = 193) is not a multiple of 16 B, so a tensor
// map cannot describe the windows without a new layout that every
// structured pass would share.
//
// The chain runs its levels (roots, then the residual) with a grid
// barrier between them; levels ping-pong through `out` and `tmp`
// (level_buf), the last root lands in `out`.  Its levels run one inlined
// body (mode 3: root or residual at run time).
#include "common.cuh"

namespace cg = cooperative_groups;

#define MFREE_THREADS 256
#define MFREE_RUN 2         // tiled: nodes a thread holds, a run along z
#define MFREE_FLAT 512      // flat: nodes of a range (two a thread)
#define MFREE_WIN 3         // window positions a thread fetches a plane
#define MFREE_MIN_BLOCKS 3  // resident blocks per SM the plan assumes

struct ElemMatrix {
  float k[64];  // K[l, l'] row-major, MFEM hex corner order
};

// The node grid and the tile shape of the plan (ops/mfree.MfreePlan):
// tiles of ty x tz nodes, ky x kz of them (flat route: ty = 0, ranges of
// tz = MFREE_FLAT flat positions, ky = 1, kz of them).
struct MfreeGeom {
  int sx, sy, NXn, NYn, NZn, n, halo, ty, tz, ky, kz;
};

// MFEM hex corner l: (0,0,0) (1,0,0) (1,1,0) (0,1,0), then the same at z=1.
__device__ __forceinline__ int corner_x(int l) {
  return ((l & 3) == 1 || (l & 3) == 2) ? 1 : 0;
}
__device__ __forceinline__ int corner_y(int l) { return (l & 3) >= 2 ? 1 : 0; }
__device__ __forceinline__ int corner_z(int l) { return l >= 4 ? 1 : 0; }

// The nine taps of x-offset DX (q = (DX+1)*9 .. (DX+1)*9 + 8) of N rows:
// each value A[u, u + delta(q)], the sum of its terms K[l, l'] c(u -
// corner(l)) in increasing l as the first design's corner loops (l outer,
// l' inner) added them, built just before its tap from the corner
// coefficients cl(h, l), then acc[h] += value * xm(h, q); the centre value
// (q = 13) goes to v13.  A value of offset DX reads the corners l with
// corner_x(l) = 0 (DX = 1), 1 (DX = -1) or both (DX = 0), so cl is called
// only for those.
template <int DX, int N, typename CL, typename XM>
__device__ __forceinline__ void mfree_taps(const ElemMatrix& K, CL cl, XM xm,
                                           float (&acc)[N],
                                           float (&v13)[N]) {
#pragma unroll
  for (int q = (DX + 1) * 9; q < (DX + 2) * 9; ++q) {
    float v[N];
#pragma unroll
    for (int h = 0; h < N; ++h) v[h] = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
#pragma unroll
      for (int lp = 0; lp < 8; ++lp) {
        if ((corner_x(lp) - corner_x(l) + 1) * 9 +
                (corner_y(lp) - corner_y(l) + 1) * 3 +
                (corner_z(lp) - corner_z(l) + 1) ==
            q) {
#pragma unroll
          for (int h = 0; h < N; ++h) v[h] += K.k[l * 8 + lp] * cl(h, l);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < N; ++h) acc[h] += v[h] * xm(h, q);
    if (q == 13) {
#pragma unroll
      for (int h = 0; h < N; ++h) v13[h] = v[h];
    }
  }
}

// The mask's epilogue of N rows from their tap sums and centre values,
// then the mode (0: spmv, 1: residual, 2: root; 3: residual when
// `residual`, else root -- a chain's levels).
template <int MODE, int N>
__device__ __forceinline__ void mfree_finish(const float (&acc)[N],
                                             const float (&v13)[N],
                                             const float (&mc)[N],
                                             const float (&xc)[N],
                                             const float (&bc)[N],
                                             const float (&dc)[N],
                                             float inv_tau, bool residual,
                                             float (&y)[N]) {
#pragma unroll
  for (int h = 0; h < N; ++h) {
    const float ax = mc[h] * acc[h] + (1.f - mc[h]) * (v13[h] * xc[h]);
    if (MODE == 0)
      y[h] = ax;
    else if (MODE == 1 || (MODE == 3 && residual))
      y[h] = bc[h] - ax;
    else
      y[h] = xc[h] + dc[h] * (bc[h] - ax) * inv_tau;
  }
}

// N whole rows: the taps xm(h, q) = (x * m) at offset q = (dx+1)*9 +
// (dy+1)*3 + (dz+1) summed in offset order (the three offsets dx in
// turn), then the epilogue.  The tiled kernel runs the same three tap
// groups and epilogue on one output at three steps (mfree_segment), so
// both kernels add the same terms in the same order.
template <int MODE, int N, typename XM>
__device__ __forceinline__ void mfree_rows(const ElemMatrix& K,
                                           const float (&cl)[N][8], XM xm,
                                           const float (&mc)[N],
                                           const float (&xc)[N],
                                           const float (&bc)[N],
                                           const float (&dc)[N],
                                           float inv_tau, bool residual,
                                           float (&y)[N]) {
  float acc[N], v13[N];
#pragma unroll
  for (int h = 0; h < N; ++h) acc[h] = 0.f;
  auto c = [&](int h, int l) { return cl[h][l]; };
  mfree_taps<-1, N>(K, c, xm, acc, v13);
  mfree_taps<0, N>(K, c, xm, acc, v13);
  mfree_taps<1, N>(K, c, xm, acc, v13);
  mfree_finish<MODE, N>(acc, v13, mc, xc, bc, dc, inv_tau, residual, y);
}

// The reference: one thread per haloed row t, every value from global
// memory (the first design of this kernel).
template <typename V, int MODE>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    mfree_point_kernel(const V* __restrict__ c, const V* __restrict__ m,
                       ElemMatrix K, long sx, long sy, long n, long halo,
                       const float* __restrict__ x,
                       const float* __restrict__ b,
                       const float* __restrict__ dinv, float inv_tau,
                       float* __restrict__ y) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n + 2 * halo) return;
  const long i = t - halo;
  if (i < 0 || i >= n) {
    y[t] = 0.f;
    return;
  }
  float cl[1][8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    cl[0][l] = ld(c, t - (corner_x(l) * sx + corner_y(l) * sy + corner_z(l)));
  auto xm = [&](int, int q) {
    const long off = (q / 9 - 1) * sx + ((q / 3) % 3 - 1) * sy + (q % 3 - 1);
    return x[t + off] * ld(m, t + off);
  };
  const float mc[1] = {ld(m, t)}, xc[1] = {x[t]},
              bc[1] = {MODE ? b[t] : 0.f}, dc[1] = {MODE == 2 ? dinv[t] : 0.f};
  float out[1];
  mfree_rows<MODE, 1>(K, cl, xm, mc, xc, bc, dc, inv_tau, false, out);
  y[t] = out[0];
}

// Shared ring of one block: two slots each of the x*m and c windows,
// (ty + 2) rows of `pitch` values; step p uses slot p & 1.
struct Ring {
  float* xm;
  float* cc;
  int pitch, slot;
};

__device__ __forceinline__ Ring make_ring(const MfreeGeom& G) {
  extern __shared__ float ring_smem[];
  Ring R;
  R.pitch = G.tz + 3;
  R.slot = (G.ty + 2) * R.pitch;
  R.xm = ring_smem;
  R.cc = ring_smem + 2 * R.slot;
  return R;
}

// A thread's part of a tile: the window positions it fetches (flat
// offset halo + y sy + z in plane 0, or -1 where no node reads it; index
// in a ring slot) and its run of MFREE_RUN nodes along z (flat offset in
// plane 0 and window index of the first; `nodes`: how many of the run are
// grid nodes, 0 for a thread with none).
struct TileThread {
  int goff[MFREE_WIN], sidx[MFREE_WIN];
  int t0, ws, nodes;
};

__device__ __forceinline__ TileThread tile_thread(const MfreeGeom& G,
                                                  const Ring& R, int tile) {
  TileThread T;
  const int y0 = (tile / G.kz) * G.ty, z0 = (tile % G.kz) * G.tz;
  const int wz = G.tz + 2, wsize = (G.ty + 2) * wz;
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    const int py = w / wz, pz = w - py * wz;
    const int y = y0 + py - 1, z = z0 + pz - 1;
    // a node reads rows y - 1 .. y + 1 and columns z - 1 .. z + 1
    const bool ok = w < wsize && y <= G.NYn && z <= G.NZn;
    T.goff[i] = ok ? G.halo + y * G.sy + z : -1;
    T.sidx[i] = py * R.pitch + pz;
  }
  const int runs = G.tz / MFREE_RUN, ly = threadIdx.x / runs;
  const int lz = MFREE_RUN * (threadIdx.x - ly * runs);
  const int y = y0 + ly, z = z0 + lz;
  T.nodes = ly < G.ty && y < G.NYn ? max(0, min(MFREE_RUN, G.NZn - z)) : 0;
  T.t0 = G.halo + y * G.sy + z;
  T.ws = (ly + 1) * R.pitch + lz + 1;
  return T;
}

// The neighbourhood of a thread's run in a ring slot (window index ws of
// its first node): x*m rows dy = -1..1, columns -1 .. MFREE_RUN; c rows
// y - 1, y, columns -1 .. MFREE_RUN - 1.
__device__ __forceinline__ void nbr_xm(const Ring& R, int s, int ws,
                                       float (&a)[3][MFREE_RUN + 2]) {
  const float* p = R.xm + s * R.slot + ws;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int k = 0; k < MFREE_RUN + 2; ++k)
      a[dy][k] = p[(dy - 1) * R.pitch + k - 1];
}

__device__ __forceinline__ void nbr_c(const Ring& R, int s, int ws,
                                      float (&a)[2][MFREE_RUN + 1]) {
  const float* p = R.cc + s * R.slot + ws;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < MFREE_RUN + 1; ++k)
      a[r][k] = p[(r - 1) * R.pitch + k - 1];
}

// What a step needs from device memory, fetched a step ahead: the thread's
// window positions of x, m and c in plane p, and its nodes' own m, x, b
// and dinv in the plane whose output the next step finishes.
struct Fetch {
  float x[MFREE_WIN], m[MFREE_WIN], c[MFREE_WIN];
  float mc[MFREE_RUN], xc[MFREE_RUN], bc[MFREE_RUN], dc[MFREE_RUN];
};

template <typename V>
__device__ __forceinline__ void fetch_window(const MfreeGeom& G,
                                             const TileThread& T, int p,
                                             const V* c, const V* m,
                                             const float* x, Fetch& F) {
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const bool ok = T.goff[i] >= 0;
    const int g = T.goff[i] + p * G.sx;
    F.x[i] = ok ? x[g] : 0.f;
    F.m[i] = ok ? ld(m, g) : 0.f;
    F.c[i] = ok ? ld(c, g) : 0.f;
  }
}

template <typename V, int MODE>
__device__ __forceinline__ void fetch_nodes(const MfreeGeom& G,
                                            const TileThread& T, int p,
                                            const V* m, const float* x,
                                            const float* b,
                                            const float* dinv, Fetch& F) {
  const int t = T.t0 + p * G.sx;
#pragma unroll
  for (int h = 0; h < MFREE_RUN; ++h) {
    F.mc[h] = ld(m, t + h);
    F.xc[h] = x[t + h];
    F.bc[h] = MODE ? b[t + h] : 0.f;
    F.dc[h] = MODE >= 2 ? dinv[t + h] : 0.f;
  }
}

__device__ __forceinline__ void put(const Ring& R, const TileThread& T,
                                    int s, const Fetch& F) {
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i)
    if (T.goff[i] >= 0) {
      R.xm[s * R.slot + T.sidx[i]] = F.x[i] * F.m[i];
      R.cc[s * R.slot + T.sidx[i]] = F.c[i];
    }
}

// Outputs [i0, i1) of tile `tile` in MODE (3: `residual` picks residual or
// root), from src into dst.  Step p (i0 - 1 .. i1) stores x*m and c of
// plane p (fetched during step p - 1) into slot p & 1, which no thread
// has read since the barrier of step p - 1, passes the step's one
// barrier, fetches plane p + 1 into registers, reads its neighbourhoods of
// plane p from the slot, and adds plane p's taps to three outputs:
//   - output p - 1: the dx = +1 taps (values from c of plane p - 1), then
//     the epilogue and the write;
//   - output p: the dx = 0 taps (c of planes p - 1 and p);
//   - output p + 1: the dx = -1 taps (c of plane p).
// A thread carries the tap sums of outputs p - 1 and p, the centre values
// of output p - 1 and its c of plane p - 1 from one step to the next: each
// output's 27 taps are added in offset order, as mfree_rows adds them.
template <typename V, int MODE>
__device__ __forceinline__ void mfree_segment(
    const MfreeGeom& G, const Ring& R, const ElemMatrix& K, int tile, int i0,
    int i1, const V* __restrict__ c, const V* __restrict__ m,
    const float* src, const float* __restrict__ b,
    const float* __restrict__ dinv, float inv_tau, bool residual,
    float* dst) {
  constexpr int N = MFREE_RUN;
  const TileThread T = tile_thread(G, R, tile);
  // acc0 / v13: output p - 1 after its dx <= 0 taps; acc1: output p after
  // its dx = -1 taps; cp: c of plane p - 1
  float acc0[N] = {}, acc1[N] = {}, v13[N] = {};
  float cp[2][N + 1] = {};
  Fetch F = {};
  fetch_window(G, T, i0 - 1, c, m, src, F);
  __syncthreads();  // no thread still reads the ring of the last segment
  for (int p = i0 - 1; p <= i1; ++p) {
    const int s = p & 1;
    put(R, T, s, F);
    __syncthreads();
    if (p < i1) fetch_window(G, T, p + 1, c, m, src, F);
    if (!T.nodes) continue;
    float xn[3][N + 2], cn[2][N + 1];
    nbr_xm(R, s, T.ws, xn);
    nbr_c(R, s, T.ws, cn);
    // tap q of node h in plane p: row dy, column dz + h
    auto xm = [&](int h, int q) { return xn[(q / 3) % 3][q % 3 + h]; };
    // corner l of node h of an output in plane o: c of plane o - corner_x
    // (l), row y - corner_y(l), column z + h - corner_z(l), from cc, the
    // neighbourhood of that plane
    auto corner = [](const float (&cc)[2][N + 1], int h, int l) {
      return cc[1 - corner_y(l)][1 + h - corner_z(l)];
    };
    if (p > i0) {  // output p - 1: its corners lie in plane p - 1
      mfree_taps<1, N>(K, [&](int h, int l) { return corner(cp, h, l); }, xm,
                       acc0, v13);
      float y[N];
      mfree_finish<MODE, N>(acc0, v13, F.mc, F.xc, F.bc, F.dc, inv_tau,
                            residual, y);
      const int t = T.t0 + (p - 1) * G.sx;
#pragma unroll
      for (int h = 0; h < N; ++h)
        if (h < T.nodes) dst[t + h] = y[h];
    }
    if (p >= i0 && p < i1) {  // output p: corners in planes p - 1 and p
      fetch_nodes<V, MODE>(G, T, p, m, src, b, dinv, F);
#pragma unroll
      for (int h = 0; h < N; ++h) acc0[h] = acc1[h];
      mfree_taps<0, N>(K, [&](int h, int l) {
        return corner_x(l) ? corner(cp, h, l) : corner(cn, h, l); }, xm,
        acc0, v13);
    }
    if (p + 1 < i1) {  // output p + 1: its corners lie in plane p
      float unused[N];
#pragma unroll
      for (int h = 0; h < N; ++h) acc1[h] = 0.f;
      mfree_taps<-1, N>(K, [&](int h, int l) { return corner(cn, h, l); }, xm,
                        acc1, unused);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < N + 1; ++k) cp[r][k] = cn[r][k];
  }
}

// Flat route: shared ring of four planes of x*m and three of c, each
// the range's window (wx = MFREE_FLAT + 2 sy + 2 values from flat offset
// -sy - 1 for x*m, wc = MFREE_FLAT + sy + 1 for c).
struct FlatRing {
  float* xm;  // [4][wx], plane ix in slot (ix + 1) & 3
  float* cc;  // [3][wc], plane ix in slot (ix + 1) % 3
  int wx, wc;
};

__device__ __forceinline__ FlatRing make_flat_ring(const MfreeGeom& G) {
  extern __shared__ float ring_smem[];
  FlatRing R;
  R.wx = MFREE_FLAT + 2 * G.sy + 2;
  R.wc = MFREE_FLAT + G.sy + 1;
  R.xm = ring_smem;
  R.cc = ring_smem + 4 * R.wx;
  return R;
}

__device__ __forceinline__ int xm_slot(int ix) { return (ix + 1) & 3; }
__device__ __forceinline__ int c_slot(int ix) { return (ix + 1) % 3; }

// A thread's share of a plane's flat windows in registers (x and m of
// the x*m window, c of the c window), and its own nodes' x, m, b and
// dinv; stored into the ring a step later.
struct FlatRegs {
  float x[MFREE_WIN], m[MFREE_WIN], c[MFREE_WIN];
  float mc[2], xc[2], bc[2], dc[2];
};

// Plane ix's x and m over the flat positions [j0 - sy - 1, j0 + MFREE_FLAT
// + sy + 1); positions past the haloed vectors load 0 (no node reads
// them).  The first MFREE_FLAT positions lie inside the window.
template <typename V>
__device__ __forceinline__ void fetch_xm(const MfreeGeom& G,
                                         const FlatRing& R, int ix, int j0,
                                         const V* m, const float* x,
                                         FlatRegs& p) {
  // 32-bit: make_geom checks that the haloed length fits; base >= 0
  const int base = G.halo + ix * G.sx + j0 - G.sy - 1;
  const int lim = G.n + 2 * G.halo - base;
  const float* xb = x + base;
  const V* mb = m + base;
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    const bool ok = ((i + 1) * MFREE_THREADS <= MFREE_FLAT || w < R.wx) &&
                    w < lim;
    p.x[i] = ok ? xb[w] : 0.f;
    p.m[i] = ok ? ld(mb, w) : 0.f;
  }
}

// Plane ix of c over [j0 - sy - 1, j0 + MFREE_FLAT), and (with `nodes`)
// the thread's own nodes of plane ix.
template <typename V, int MODE>
__device__ __forceinline__ void fetch_c(const MfreeGeom& G,
                                        const FlatRing& R, int ix, int j0,
                                        bool nodes, const V* c, const V* m,
                                        const float* x, const float* b,
                                        const float* dinv, FlatRegs& p) {
  const int base = G.halo + ix * G.sx + j0 - G.sy - 1;
  const int lim = G.n + 2 * G.halo - base;
  const V* cb = c + base;
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    const bool ok = ((i + 1) * MFREE_THREADS <= MFREE_FLAT || w < R.wc) &&
                    w < lim;
    p.c[i] = ok ? ld(cb, w) : 0.f;
  }
  if (!nodes) return;
  // the nodes' rows; a node past the plane's end reads the plane's first
  const int t0 = G.halo + ix * G.sx + j0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = threadIdx.x + h * MFREE_THREADS;
    const int t = t0 + (j0 + j < G.sx ? j : -j0);
    p.mc[h] = ld(m, t);
    p.xc[h] = x[t];
    p.bc[h] = MODE ? b[t] : 0.f;
    p.dc[h] = MODE >= 2 ? dinv[t] : 0.f;
  }
}

__device__ __forceinline__ void put_xm(const FlatRing& R, int ix,
                                       const FlatRegs& p) {
  float* xs = R.xm + xm_slot(ix) * R.wx;
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    if (w < R.wx) xs[w] = p.x[i] * p.m[i];
  }
}

__device__ __forceinline__ void put_c(const FlatRing& R, int ix,
                                      const FlatRegs& p) {
  float* cs = R.cc + c_slot(ix) * R.wc;
#pragma unroll
  for (int i = 0; i < MFREE_WIN; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    if (w < R.wc) cs[w] = p.c[i];
  }
}

// Flat route: outputs [i0, i1) of range `tile` in MODE (3: `residual`
// picks residual or root), from src into dst.  Step ix stores plane ix +
// 1 of x*m and plane ix of c (fetched during step ix - 1) into ring slots
// that no thread still reads -- the ring holds one plane more than a node
// reads -- fetches the next step's planes into registers, passes the
// step's one barrier and computes plane ix's nodes from the ring.
template <typename V, int MODE>
__device__ __forceinline__ void mfree_flat_item(
    const MfreeGeom& G, const ElemMatrix& K, int tile, int i0, int i1,
    const V* __restrict__ c, const V* __restrict__ m, const float* src,
    const float* __restrict__ b, const float* __restrict__ dinv,
    float inv_tau, bool residual, float* dst) {
  const FlatRing R = make_flat_ring(G);
  const int j0 = tile * MFREE_FLAT;
  FlatRegs a, nx;
  fetch_xm(G, R, i0 - 1, j0, m, src, a);
  fetch_c<V, MODE>(G, R, i0 - 1, j0, false, c, m, src, b, dinv, a);
  fetch_xm(G, R, i0, j0, m, src, nx);
  __syncthreads();  // no thread still reads the ring of the last item
  put_xm(R, i0 - 1, a);
  put_c(R, i0 - 1, a);
  put_xm(R, i0, nx);
  fetch_xm(G, R, i0 + 1, j0, m, src, nx);
  fetch_c<V, MODE>(G, R, i0, j0, true, c, m, src, b, dinv, nx);
  for (int ix = i0; ix < i1; ++ix) {
    put_xm(R, ix + 1, nx);
    put_c(R, ix, nx);
    const FlatRegs cur = nx;
    if (ix + 1 < i1) {
      fetch_xm(G, R, ix + 2, j0, m, src, nx);
      fetch_c<V, MODE>(G, R, ix + 1, j0, true, c, m, src, b, dinv, nx);
    }
    __syncthreads();
    // both nodes of the thread, side by side; a node past the plane's end
    // (the last range) computes from ring values no store keeps
    float cl[2][8];
    int w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // window position of the node: its flat offset from the range start
      w[h] = threadIdx.x + h * MFREE_THREADS + G.sy + 1;
#pragma unroll
      for (int l = 0; l < 8; ++l)
        cl[h][l] = R.cc[c_slot(ix - corner_x(l)) * R.wc + w[h] -
                        corner_y(l) * G.sy - corner_z(l)];
    }
    auto xm = [&](int h, int q) {
      return R.xm[xm_slot(ix + q / 9 - 1) * R.wx + w[h] +
                  ((q / 3) % 3 - 1) * G.sy + (q % 3 - 1)];
    };
    float y[2];
    mfree_rows<MODE, 2>(K, cl, xm, cur.mc, cur.xc, cur.bc, cur.dc, inv_tau,
                        residual, y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + threadIdx.x + h * MFREE_THREADS;
      if (j < G.sx) dst[G.halo + ix * G.sx + j] = y[h];
    }
  }
}

// The block's items of a level: the tiles x chunks of planes (as many
// chunks as leave an item a block, the planes split evenly), item i on
// block i, so that all tiles of a chunk march their planes side by side
// and share their window halos in L2.
template <typename V, int MODE, bool FLAT>
__device__ __forceinline__ void mfree_share(
    const MfreeGeom& G, const ElemMatrix& K, const V* __restrict__ c,
    const V* __restrict__ m, const float* src, const float* __restrict__ b,
    const float* __restrict__ dinv, float inv_tau, bool residual,
    float* dst) {
  const int tiles = G.ky * G.kz;
  const int chunks = max(1, min(G.NXn, (int)gridDim.x / tiles));
  for (int it = blockIdx.x; it < tiles * chunks; it += gridDim.x) {
    const int k = it / tiles;
    const int i0 = k * G.NXn / chunks, i1 = (k + 1) * G.NXn / chunks;
    if (FLAT)
      mfree_flat_item<V, MODE>(G, K, it % tiles, i0, i1, c, m, src, b, dinv,
                               inv_tau, residual, dst);
    else
      mfree_segment<V, MODE>(G, make_ring(G), K, it % tiles, i0, i1, c, m,
                             src, b, dinv, inv_tau, residual, dst);
  }
}

// Zero halo rows of y, spread over the grid.
__device__ __forceinline__ void zero_halo(const MfreeGeom& G, float* y) {
  for (long h = (long)blockIdx.x * blockDim.x + threadIdx.x; h < 2L * G.halo;
       h += (long)gridDim.x * blockDim.x)
    y[h < G.halo ? h : (long)G.n + h] = 0.f;
}

// One pass over the block's share (FLAT: the flat route).
template <typename V, int MODE, bool FLAT>
__global__ void __launch_bounds__(MFREE_THREADS, MFREE_MIN_BLOCKS)
    mfree_pass_kernel(const V* __restrict__ c, const V* __restrict__ m,
                      ElemMatrix K, MfreeGeom G, const float* __restrict__ x,
                      const float* __restrict__ b,
                      const float* __restrict__ dinv, float inv_tau,
                      float* __restrict__ y) {
  zero_halo(G, y);
  mfree_share<V, MODE, FLAT>(G, K, c, m, x, b, dinv, inv_tau, false, y);
}

// A chain: k roots and (RES) the residual, one level at a time, a grid
// barrier between levels.
template <typename V, bool RES, bool FLAT>
__global__ void __launch_bounds__(MFREE_THREADS, MFREE_MIN_BLOCKS)
    mfree_chain_kernel(const V* __restrict__ c, const V* __restrict__ m,
                       ElemMatrix K, MfreeGeom G, Taus taus,
                       const float* __restrict__ b,
                       const float* __restrict__ dinv, const float* x0,
                       float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  zero_halo(G, out);
  if (taus.k > 1) zero_halo(G, tmp);
  if (RES) zero_halo(G, res);
  const int L = taus.k + (RES ? 1 : 0);
  const float* src = x0;
  for (int r = 1; r <= L; ++r) {
    float* dst = r <= taus.k ? level_buf(r, taus.k, out, tmp) : res;
    const float it_r = r <= taus.k ? taus.inv_tau[r - 1] : 0.f;
    mfree_share<V, 3, FLAT>(G, K, c, m, src, b, dinv, it_r, r > taus.k,
                            dst);
    if (r < L) grid.sync();
    src = dst;
  }
}

static long mfree_smem(const MfreeGeom& G, bool flat) {
  if (flat)
    return 4L * (4L * (MFREE_FLAT + 2L * G.sy + 2) +
                 3L * (MFREE_FLAT + G.sy + 1));
  return 4L * 4L * (G.ty + 2) * (G.tz + 3);
}

// Geometry and plan checks of both launchers; plan: route (0 tiled, 1
// flat), ty, tz, ky, kz, blocks, shared bytes (ops/mfree.MfreePlan.ints).
static cudaError_t make_geom(int NXn, int NYn, int NZn, int halo,
                             const int* plan, MfreeGeom* G) {
  const long sx = (long)NYn * NZn, sy = NZn;
  const long n = (long)NXn * sx, total = n + 2L * halo;
  const bool flat = plan[0] == 1;
  // 32-bit flat offsets: every value read lies in [0, total); a flat
  // window's last position below total + sx + 2 MFREE_FLAT
  if (NXn < 2 || NYn < 2 || NZn < 2 || halo < sx + sy + 1 ||
      total + (flat ? sx + 2L * MFREE_FLAT : 0L) > 0x7fffffffL)
    return cudaErrorInvalidValue;
  *G = {(int)sx, (int)sy, NXn, NYn, NZn, (int)n, halo,
        plan[1], plan[2], plan[3], plan[4]};
  const long ty = G->ty, tz = G->tz;
  const bool tiles_ok =
      flat ? ty == 0 && tz == MFREE_FLAT && G->ky == 1 &&
                 (long)G->kz * tz >= sx && (long)(G->kz - 1) * tz < sx &&
                 MFREE_FLAT + 2 * sy + 2 <= (long)MFREE_WIN * MFREE_THREADS
           : ty >= 1 && tz >= MFREE_RUN && tz % MFREE_RUN == 0 &&
                 (tz / MFREE_RUN) * ty <= MFREE_THREADS &&
                 (ty + 2) * (tz + 2) <= (long)MFREE_WIN * MFREE_THREADS &&
                 G->ky * ty >= NYn && (G->ky - 1) * ty < NYn &&
                 G->kz * tz >= NZn && (G->kz - 1) * tz < NZn;
  if (plan[0] < 0 || plan[0] > 1 || !tiles_ok || plan[5] < 1 ||
      plan[6] != mfree_smem(*G, flat) || plan[6] > 232448)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

static ElemMatrix make_k(const float* K) {
  ElemMatrix Km;
  for (int i = 0; i < 64; ++i) Km.k[i] = K[i];
  return Km;
}

template <typename V, int MODE, bool FLAT>
static cudaError_t launch_pass_r(const V* c, const V* m, const ElemMatrix& K,
                                 const MfreeGeom& G, int blocks, int smem,
                                 const float* x, const float* b,
                                 const float* dinv, float inv_tau, float* y,
                                 cudaStream_t s) {
  const void* f = (const void*)mfree_pass_kernel<V, MODE, FLAT>;
  cudaError_t e = smem_limit(f, smem);
  if (e != cudaSuccess) return e;
  mfree_pass_kernel<V, MODE, FLAT><<<blocks, MFREE_THREADS, smem, s>>>(
      c, m, K, G, x, b, dinv, inv_tau, y);
  return cudaGetLastError();
}

template <typename V, int MODE>
static cudaError_t launch_pass(bool flat, const V* c, const V* m,
                               const ElemMatrix& K, const MfreeGeom& G,
                               int blocks, int smem, const float* x,
                               const float* b, const float* dinv,
                               float inv_tau, float* y, cudaStream_t s) {
  return flat ? launch_pass_r<V, MODE, true>(c, m, K, G, blocks, smem, x, b,
                                             dinv, inv_tau, y, s)
              : launch_pass_r<V, MODE, false>(c, m, K, G, blocks, smem, x,
                                              b, dinv, inv_tau, y, s);
}

template <typename V>
static cudaError_t pass_typed(int mode, bool flat, const V* c, const V* m,
                              const ElemMatrix& K, const MfreeGeom& G,
                              int blocks, int smem, const float* x,
                              const float* b, const float* dinv,
                              float inv_tau, float* y, cudaStream_t s) {
  if (mode == 0) return launch_pass<V, 0>(flat, c, m, K, G, blocks, smem, x,
                                          b, dinv, inv_tau, y, s);
  if (mode == 1) return launch_pass<V, 1>(flat, c, m, K, G, blocks, smem, x,
                                          b, dinv, inv_tau, y, s);
  if (mode == 2) return launch_pass<V, 2>(flat, c, m, K, G, blocks, smem, x,
                                          b, dinv, inv_tau, y, s);
  return cudaErrorInvalidValue;
}

extern "C" int saamge_mfree(int mode, const void* c, const void* m,
                            int cm_bf16, const float* K, int NXn, int NYn,
                            int NZn, int halo, const int* plan,
                            const float* x, const float* b, const float* dinv,
                            float inv_tau, float* y, void* stream) {
  if (mode < 0 || mode > 2 || (mode >= 1 && b == nullptr) ||
      (mode == 2 && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  MfreeGeom G;
  cudaError_t e = make_geom(NXn, NYn, NZn, halo, plan, &G);
  if (e != cudaSuccess) return (int)e;
  const ElemMatrix Km = make_k(K);
  cudaStream_t s = (cudaStream_t)stream;
  const bool flat = plan[0] == 1;
  e = cm_bf16 ? pass_typed(mode, flat, (const __nv_bfloat16*)c,
                           (const __nv_bfloat16*)m, Km, G, plan[5], plan[6],
                           x, b, dinv, inv_tau, y, s)
              : pass_typed(mode, flat, (const float*)c, (const float*)m, Km,
                           G, plan[5], plan[6], x, b, dinv, inv_tau, y, s);
  return (int)e;
}

// The chain's grid: the plan's blocks, or fewer where fewer fit the card
// at once (each block takes an equal share of whatever grid runs).
template <typename V>
static cudaError_t launch_chain(bool flat, const V* c, const V* m,
                                ElemMatrix K, MfreeGeom G, int blocks,
                                int smem, Taus taus,
                                int emit_res, const float* b,
                                const float* dinv, const float* x0,
                                float* out, float* tmp, float* res,
                                cudaStream_t s) {
  void* args[] = {(void*)&c,  (void*)&m,    (void*)&K,   (void*)&G,
                  (void*)&taus, (void*)&b,  (void*)&dinv, (void*)&x0,
                  (void*)&out, (void*)&tmp, (void*)&res};
  const void* f =
      emit_res ? (flat ? (const void*)mfree_chain_kernel<V, true, true>
                       : (const void*)mfree_chain_kernel<V, true, false>)
               : (flat ? (const void*)mfree_chain_kernel<V, false, true>
                       : (const void*)mfree_chain_kernel<V, false, false>);
  return launch_cooperative(f, (long)blocks * MFREE_THREADS, args, s,
                            MFREE_THREADS, (size_t)smem);
}

extern "C" int saamge_mfree_chain(const void* c, const void* m, int cm_bf16,
                                  const float* K, int NXn, int NYn, int NZn,
                                  int halo, const int* plan,
                                  const float* inv_taus, int n_roots,
                                  int emit_res, const float* b,
                                  const float* dinv, const float* x0,
                                  float* out, float* tmp, float* res,
                                  void* stream) {
  if (n_roots < 1 || n_roots > SAAMGE_MAX_ROOTS)
    return (int)cudaErrorInvalidValue;
  MfreeGeom G;
  cudaError_t e = make_geom(NXn, NYn, NZn, halo, plan, &G);
  if (e != cudaSuccess) return (int)e;
  const ElemMatrix Km = make_k(K);
  const Taus taus = make_taus(inv_taus, n_roots);
  cudaStream_t s = (cudaStream_t)stream;
  const bool flat = plan[0] == 1;
  e = cm_bf16 ? launch_chain(flat, (const __nv_bfloat16*)c,
                             (const __nv_bfloat16*)m, Km, G, plan[5],
                             plan[6], taus, emit_res, b, dinv, x0, out, tmp,
                             res, s)
              : launch_chain(flat, (const float*)c, (const float*)m, Km, G,
                             plan[5], plan[6], taus, emit_res, b, dinv, x0,
                             out, tmp, res, s);
  return (int)e;
}

// The reference pass, one thread a row (no plan).
extern "C" int saamge_mfree_point(int mode, const void* c, const void* m,
                                  int cm_bf16, const float* K, int NXn,
                                  int NYn, int NZn, int halo, const float* x,
                                  const float* b, const float* dinv,
                                  float inv_tau, float* y, void* stream) {
  const long sx = (long)NYn * NZn, sy = NZn, n = (long)NXn * sx;
  if (NXn < 2 || NYn < 2 || NZn < 2 || halo < sx + sy + 1 || mode < 0 ||
      mode > 2 || (mode >= 1 && b == nullptr) ||
      (mode == 2 && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  const ElemMatrix Km = make_k(K);
  const dim3 grid((unsigned)((n + 2L * halo + SAAMGE_THREADS - 1) /
                             SAAMGE_THREADS));
  cudaStream_t s = (cudaStream_t)stream;
#define MFREE_POINT(V, MODE)                                              \
  mfree_point_kernel<V, MODE><<<grid, SAAMGE_THREADS, 0, s>>>(            \
      (const V*)c, (const V*)m, Km, sx, sy, n, (long)halo, x, b, dinv,    \
      inv_tau, y)
  if (cm_bf16) {
    if (mode == 0) MFREE_POINT(__nv_bfloat16, 0);
    else if (mode == 1) MFREE_POINT(__nv_bfloat16, 1);
    else MFREE_POINT(__nv_bfloat16, 2);
  } else {
    if (mode == 0) MFREE_POINT(float, 0);
    else if (mode == 1) MFREE_POINT(float, 1);
    else MFREE_POINT(float, 2);
  }
#undef MFREE_POINT
  return (int)cudaGetLastError();
}
