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
// Bound on this card: per node a pass reads c, m, x (and b, dinv) and
// writes y -- about 20 B/node with bf16 c and m -- and does ~91 FMAs and
// 35 shared loads.  The first design, one thread per node, made 62 global
// loads a node (8 of c, 27 of x, 27 of m), bound by the load units and L1.
// Design: a block owns a tile of MFREE_NODES consecutive nodes of the
// flat (y, z) plane index and marches along x over a chunk of planes
// (ops/mfree.mfree_plan: the chunks are cut so that the tiles x chunks
// fill MFREE_MIN_BLOCKS blocks an SM).  Shared memory holds a ring of four
// planes of x*m (f32) and three of c (widened), each the tile's range
// plus the halo that its taps reach (sy + 1 nodes on each side for x*m,
// below it for c).  The ring keeps one barrier a plane: plane ix + 1 of
// x*m and plane ix of c are stored into slots that no thread still reads,
// then the plane's nodes are computed from the ring.  A thread fetches
// the next plane's window values into registers before it computes the
// current plane, so the loads fly during the compute (the first build
// loaded and stored each value in turn and ran at 18.1 us a pass at n=96,
// slower than the first design).  Each node loads c, m and x about
// 1.4-2 times (the ranges' halos and a chunk's first planes) and its own
// x, m, b and dinv once.  Because the ranges are flat, a tap that leaves
// the tile's (y, z) rows reads the node the old kernel read at the same
// flat offset, and meets the same zero c.  A thread computes its two
// nodes side by side (mfree_rows): each of the 27 values is rebuilt from
// the 8 c values just before its tap, with its terms in the old kernel's
// order, so the two 27-FMA tap chains interleave.  The arithmetic is that
// of the old kernel -- the one-thread-a-node reference
// mfree_point_kernel shares mfree_rows -- so the pass equals it bit for
// bit.  Halo rows are written as zeros, so the output chains.  What holds
// it back now is issue: the rows' FMAs and shared loads and the
// fetches' index arithmetic, at one barrier a plane (PERF.md, PR 7).
//
// The chain runs its levels (roots, then the residual) with a grid
// barrier between them; levels ping-pong through `out` and `tmp`
// (level_buf), the last root lands in `out`.  Its working set -- c and m
// in bf16, x, tmp, b, dinv and res in f32, ~22 MB at n=96 -- fits the
// 50 MB L2, so every level after the first runs from L2.  Its levels run
// one inlined item body (mode 3: root or residual at run time): two
// bodies, one a mode, were not inlined and spilled.
#include "common.cuh"

namespace cg = cooperative_groups;

#define MFREE_THREADS 256
#define MFREE_NODES 512     // nodes of a tile (two a thread)
#define MFREE_MIN_BLOCKS 3  // resident blocks per SM the plan assumes

struct ElemMatrix {
  float k[64];  // K[l, l'] row-major, MFEM hex corner order
};

// The plan (ops/mfree.MfreePlan): planes of a chunk, tiles of a plane,
// chunks, and the ring's window widths.
struct MfreeGeom {
  int sx, sy, NXn, n, halo, chunk, tiles, chunks;
};

// MFEM hex corner l: (0,0,0) (1,0,0) (1,1,0) (0,1,0), then the same at z=1.
__device__ __forceinline__ int corner_x(int l) {
  return ((l & 3) == 1 || (l & 3) == 2) ? 1 : 0;
}
__device__ __forceinline__ int corner_y(int l) { return (l & 3) >= 2 ? 1 : 0; }
__device__ __forceinline__ int corner_z(int l) { return l >= 4 ? 1 : 0; }

// N rows at once: each row's 27 values from its 8 corner coefficients
// cl, the taps xm(h, q) = (x * m) at offset q = (dx+1)*9 + (dy+1)*3 +
// (dz+1) summed in offset order, the mask's epilogue, then the mode (0:
// spmv, 1: residual, 2: root; 3: residual when `residual`, else root --
// a chain's levels).  A value A[u, u + delta(q)] is the sum of its terms
// K[l, l'] c(u - corner(l)) in increasing l, as the first design's
// corner loops (l outer, l' inner) added them; here it is built just
// before its tap, so that the rows' 27-FMA tap chains run side by side.
// Every pass of this file computes its rows with this function.
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
#pragma unroll
  for (int q = 0; q < 27; ++q) {
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
          for (int h = 0; h < N; ++h) v[h] += K.k[l * 8 + lp] * cl[h][l];
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

// Shared ring of one block: four planes of x*m, three of c.
struct Ring {
  float* xm;  // [4][wx], plane ix in slot (ix + 1) & 3
  float* cc;  // [3][wc], plane ix in slot (ix + 1) % 3
  int wx, wc;
};

__device__ __forceinline__ int xm_slot(int ix) { return (ix + 1) & 3; }
__device__ __forceinline__ int c_slot(int ix) { return (ix + 1) % 3; }

// One thread's share of a plane's ring windows, in registers: XW values
// of x and m (x*m window, wx <= XW * MFREE_THREADS) and of c (wc < wx),
// and its own nodes' x, m, b and dinv.  Loads go here first and reach
// shared memory only a plane later, so that they fly while the block
// computes.
template <int XW>
struct PlaneRegs {
  float x[XW], m[XW], c[XW];
  float mc[2], xc[2], bc[2], dc[2];
};

// Plane ix's x and m over the flat plane positions [j0 - sy - 1, j0 +
// NODES + sy + 1) of a tile; positions outside the haloed vectors load
// 0 (no node reads them).  The first NODES positions are inside the
// window (wx > NODES) and need no test against it.
template <typename V, int XW>
__device__ __forceinline__ void fetch_xm(const MfreeGeom& G, const Ring& R,
                                         int ix, int j0, const V* m,
                                         const float* x, PlaneRegs<XW>& p) {
  // 32-bit: make_geom checks that the haloed length fits; base >= 0
  const int base = G.halo + ix * G.sx + j0 - G.sy - 1;
  const int lim = G.n + 2 * G.halo - base;
  const float* xb = x + base;
  const V* mb = m + base;
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    const bool ok = ((i + 1) * MFREE_THREADS <= MFREE_NODES || w < R.wx) &&
                    w < lim;
    p.x[i] = ok ? xb[w] : 0.f;
    p.m[i] = ok ? ld(mb, w) : 0.f;
  }
}

// Plane ix of c over [j0 - sy - 1, j0 + NODES), and (with `nodes`) the
// thread's own nodes of plane ix.
template <typename V, int MODE, int XW>
__device__ __forceinline__ void fetch_c(const MfreeGeom& G, const Ring& R,
                                        int ix, int j0, bool nodes,
                                        const V* c, const V* m,
                                        const float* x, const float* b,
                                        const float* dinv,
                                        PlaneRegs<XW>& p) {
  const int base = G.halo + ix * G.sx + j0 - G.sy - 1;
  const int lim = G.n + 2 * G.halo - base;
  const V* cb = c + base;
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    const bool ok = ((i + 1) * MFREE_THREADS <= MFREE_NODES || w < R.wc) &&
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

template <int XW>
__device__ __forceinline__ void put_xm(const Ring& R, int ix,
                                       const PlaneRegs<XW>& p) {
  float* xs = R.xm + xm_slot(ix) * R.wx;
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    if (w < R.wx) xs[w] = p.x[i] * p.m[i];
  }
}

template <int XW>
__device__ __forceinline__ void put_c(const Ring& R, int ix,
                                      const PlaneRegs<XW>& p) {
  float* cs = R.cc + c_slot(ix) * R.wc;
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    const int w = threadIdx.x + i * MFREE_THREADS;
    if (w < R.wc) cs[w] = p.c[i];
  }
}

// One item of a level: tile `tile` of the planes of chunk `chunk`, in
// MODE (3: `residual` picks residual or root), from src into dst.  Step ix stores plane ix + 1 of x*m and plane
// ix of c (fetched during step ix - 1) into ring slots that no thread
// still reads -- the ring holds one plane more than a node reads -- then
// fetches the next step's planes into registers, passes the one barrier
// of the step, and computes plane ix's nodes from the ring.
template <typename V, int MODE, int XW>
__device__ __forceinline__ void mfree_item(
    const MfreeGeom& G, const Ring& R, const ElemMatrix& K, int tile,
    int chunk, const V* __restrict__ c, const V* __restrict__ m,
    const float* src, const float* __restrict__ b,
    const float* __restrict__ dinv, float inv_tau, bool residual,
    float* dst) {
  const int j0 = tile * MFREE_NODES, i0 = chunk * G.chunk;
  const int i1 = min(G.NXn, i0 + G.chunk);
  PlaneRegs<XW> a, nx;
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
    const PlaneRegs<XW> cur = nx;
    if (ix + 1 < i1) {
      fetch_xm(G, R, ix + 2, j0, m, src, nx);
      fetch_c<V, MODE>(G, R, ix + 1, j0, true, c, m, src, b, dinv, nx);
    }
    __syncthreads();
    // both nodes of the thread, side by side; a node past the plane's end
    // (the last tile) computes from ring values no store keeps
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

// Zero halo rows of y, spread over the grid.
__device__ __forceinline__ void zero_halo(const MfreeGeom& G, float* y) {
  for (long h = (long)blockIdx.x * blockDim.x + threadIdx.x; h < 2L * G.halo;
       h += (long)gridDim.x * blockDim.x)
    y[h < G.halo ? h : (long)G.n + h] = 0.f;
}

__device__ __forceinline__ Ring make_ring(const MfreeGeom& G) {
  extern __shared__ float ring_smem[];
  Ring R;
  R.wx = MFREE_NODES + 2 * G.sy + 2;
  R.wc = MFREE_NODES + G.sy + 1;
  R.xm = ring_smem;
  R.cc = ring_smem + 4 * R.wx;
  return R;
}

// One pass: block `blockIdx.x` takes one item.
template <typename V, int MODE, int XW>
__global__ void __launch_bounds__(MFREE_THREADS, MFREE_MIN_BLOCKS)
    mfree_pass_kernel(const V* __restrict__ c, const V* __restrict__ m,
                      ElemMatrix K, MfreeGeom G, const float* __restrict__ x,
                      const float* __restrict__ b,
                      const float* __restrict__ dinv, float inv_tau,
                      float* __restrict__ y) {
  const Ring R = make_ring(G);
  zero_halo(G, y);
  mfree_item<V, MODE, XW>(G, R, K, blockIdx.x % G.tiles,
                          blockIdx.x / G.tiles, c, m, x, b, dinv, inv_tau,
                          false, y);
}

// A chain: k roots and (RES) the residual, one level at a time, a grid
// barrier between levels; each block loops over the items.
template <typename V, bool RES, int XW>
__global__ void __launch_bounds__(MFREE_THREADS, MFREE_MIN_BLOCKS)
    mfree_chain_kernel(const V* __restrict__ c, const V* __restrict__ m,
                       ElemMatrix K, MfreeGeom G, Taus taus,
                       const float* __restrict__ b,
                       const float* __restrict__ dinv, const float* x0,
                       float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  const Ring R = make_ring(G);
  zero_halo(G, out);
  if (taus.k > 1) zero_halo(G, tmp);
  if (RES) zero_halo(G, res);
  const int L = taus.k + (RES ? 1 : 0), items = G.tiles * G.chunks;
  const float* src = x0;
  for (int r = 1; r <= L; ++r) {
    float* dst = r <= taus.k ? level_buf(r, taus.k, out, tmp) : res;
    const float it_r = r <= taus.k ? taus.inv_tau[r - 1] : 0.f;
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      mfree_item<V, 3, XW>(G, R, K, it % G.tiles, it / G.tiles, c, m, src, b,
                           dinv, it_r, r > taus.k, dst);
    if (r < L) grid.sync();
    src = dst;
  }
}

// Window values a thread fetches per plane (PlaneRegs<XW>): 3 up to
// NZn = 127, 6 up to NZn = 511; 0 beyond.
static int mfree_xw(const MfreeGeom& G) {
  const long wx = MFREE_NODES + 2L * G.sy + 2;
  return wx <= 3 * MFREE_THREADS ? 3 : wx <= 6 * MFREE_THREADS ? 6 : 0;
}

static long mfree_smem(const MfreeGeom& G) {
  return 4L * (4L * (MFREE_NODES + 2L * G.sy + 2) +
               3L * (MFREE_NODES + G.sy + 1));
}

// Geometry and plan checks of both launchers; plan: chunk, tiles,
// chunks, shared bytes (ops/mfree.MfreePlan.ints).
static cudaError_t make_geom(int NXn, int NYn, int NZn, int halo,
                             const int* plan, MfreeGeom* G) {
  const long sx = (long)NYn * NZn, sy = NZn;
  const long n = (long)NXn * sx, total = n + 2L * halo;
  // 32-bit window indices: the last window ends below total + sx + NODES
  if (NXn < 2 || NYn < 2 || NZn < 2 || halo < sx + sy + 1 ||
      total + sx + 2L * MFREE_NODES > 0x7fffffffL)
    return cudaErrorInvalidValue;
  *G = {(int)sx, (int)sy, NXn, (int)n, halo, plan[0], plan[1], plan[2]};
  if (G->chunk < 1 || (long)G->chunks * G->chunk < NXn ||
      (long)(G->chunks - 1) * G->chunk >= NXn ||
      (long)G->tiles * MFREE_NODES < sx ||
      (long)(G->tiles - 1) * MFREE_NODES >= sx ||
      plan[3] != mfree_smem(*G) || plan[3] > 232448 || !mfree_xw(*G))
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

static ElemMatrix make_k(const float* K) {
  ElemMatrix Km;
  for (int i = 0; i < 64; ++i) Km.k[i] = K[i];
  return Km;
}

template <typename V, int MODE, int XW>
static cudaError_t launch_pass_w(const V* c, const V* m, const ElemMatrix& K,
                                 const MfreeGeom& G, int smem, const float* x,
                                 const float* b, const float* dinv,
                                 float inv_tau, float* y, cudaStream_t s) {
  const void* f = (const void*)mfree_pass_kernel<V, MODE, XW>;
  cudaError_t e = smem_limit(f, smem);
  if (e != cudaSuccess) return e;
  mfree_pass_kernel<V, MODE, XW>
      <<<G.tiles * G.chunks, MFREE_THREADS, smem, s>>>(c, m, K, G, x, b, dinv,
                                                       inv_tau, y);
  return cudaGetLastError();
}

template <typename V, int MODE>
static cudaError_t launch_pass(const V* c, const V* m, const ElemMatrix& K,
                               const MfreeGeom& G, int smem, const float* x,
                               const float* b, const float* dinv,
                               float inv_tau, float* y, cudaStream_t s) {
  return mfree_xw(G) == 3
             ? launch_pass_w<V, MODE, 3>(c, m, K, G, smem, x, b, dinv,
                                         inv_tau, y, s)
             : launch_pass_w<V, MODE, 6>(c, m, K, G, smem, x, b, dinv,
                                         inv_tau, y, s);
}

template <typename V>
static cudaError_t pass_typed(int mode, const V* c, const V* m,
                              const ElemMatrix& K, const MfreeGeom& G,
                              int smem, const float* x, const float* b,
                              const float* dinv, float inv_tau, float* y,
                              cudaStream_t s) {
  if (mode == 0) return launch_pass<V, 0>(c, m, K, G, smem, x, b, dinv,
                                          inv_tau, y, s);
  if (mode == 1) return launch_pass<V, 1>(c, m, K, G, smem, x, b, dinv,
                                          inv_tau, y, s);
  if (mode == 2) return launch_pass<V, 2>(c, m, K, G, smem, x, b, dinv,
                                          inv_tau, y, s);
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
  e = cm_bf16 ? pass_typed(mode, (const __nv_bfloat16*)c,
                           (const __nv_bfloat16*)m, Km, G, plan[3], x, b,
                           dinv, inv_tau, y, s)
              : pass_typed(mode, (const float*)c, (const float*)m, Km, G,
                           plan[3], x, b, dinv, inv_tau, y, s);
  return (int)e;
}

template <typename V>
static cudaError_t launch_chain(const V* c, const V* m, ElemMatrix K,
                                MfreeGeom G, int smem, Taus taus,
                                int emit_res, const float* b,
                                const float* dinv, const float* x0,
                                float* out, float* tmp, float* res,
                                cudaStream_t s) {
  void* args[] = {(void*)&c,  (void*)&m,    (void*)&K,   (void*)&G,
                  (void*)&taus, (void*)&b,  (void*)&dinv, (void*)&x0,
                  (void*)&out, (void*)&tmp, (void*)&res};
  const bool w3 = mfree_xw(G) == 3;
  const void* f =
      emit_res ? (w3 ? (const void*)mfree_chain_kernel<V, true, 3>
                     : (const void*)mfree_chain_kernel<V, true, 6>)
               : (w3 ? (const void*)mfree_chain_kernel<V, false, 3>
                     : (const void*)mfree_chain_kernel<V, false, 6>);
  return launch_cooperative(f, (long)G.tiles * G.chunks * MFREE_THREADS,
                            args, s, MFREE_THREADS, (size_t)smem);
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
  e = cm_bf16 ? launch_chain((const __nv_bfloat16*)c,
                             (const __nv_bfloat16*)m, Km, G, plan[3], taus,
                             emit_res, b, dinv, x0, out, tmp, res, s)
              : launch_chain((const float*)c, (const float*)m, Km, G,
                             plan[3], taus, emit_res, b, dinv, x0, out, tmp,
                             res, s);
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
