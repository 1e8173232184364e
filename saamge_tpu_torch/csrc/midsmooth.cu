// Kernel 4: one mid-level smoothing chain on the brick-block operator --
// k chained roots  x_r = x_{r-1} + d (b - A1 x_{r-1}) / tau_r  and
// optionally the trailing residual b - A1 x_k, in ONE launch, with the
// operator resident in shared memory.
//
// Operator (slot-major padded layout, coarse dof (p, s) at s * NB + p):
//   A1[(p, s1), (p + doff_k, s2)] for s1 < r1_k, s2 < r2_k
// over <= 27 brick offsets doff_k with used-slot rectangles (r1_k, r2_k),
// stored tile-major (ops/midsmooth.pack_tiles): tile j holds bricks
// [j T, j T + T), and within it row (k, s1, s2) -- in the order of the
// packed rectangles, offset k after offset k - 1, s1 then s2 -- is T
// consecutive values, one per brick (zeros past NB).  A tile is one
// contiguous range of `stride` values, 16-byte aligned.
//
// Replaces: saamge_tpu/ops/pallas_midsmooth.py `_build_mid_chain` (the
// VMEM-resident Pallas chain behind mid_chain), which loads the packed
// rectangles into fast memory once per chain and runs every root there.
//
// Differences from the TPU kernel, on purpose:
//  * the neighbour brick p + doff is computed with an explicit bounds
//    check; a wrapped neighbour reads x as 0, as the
//    plain version's zero pad does.  The TPU kernel's lane roll wraps and
//    relies on structurally zero blocks at wrapped lanes.
//  * the rectangles are stored in full.  The TPU kernel's symmetry
//    halving (_sym_keep, prep_blocksT(sym=True)) keeps only the
//    non-negative offsets and applies each block both ways; here its
//    transposed half would need the blocks of bricks p - d, which lie
//    mostly in other blocks' tiles.  A resident chain reads the operator
//    from device memory once, so halving saves at most that one read
//    (~2.4 us of 15.8 MB at n=96): a storage option, not taken.
//  * bf16 blocks are widened to f32 and multiplied by the f32 x in f32
//    (the TPU kernel multiplies in bf16); x stays f32 across roots, and
//    padded slots stay zero because their d is 0.
//
// Bound on this card: the first design (one thread per output, each
// walking 27 offsets x r2 slots in one dependent chain of global loads,
// the blocks re-read through L2 every root) was bound by latency, ~70 us
// a root at n=96.  The bytes a chain must move are the rectangles once
// (15.8 MB of bf16 at n=96, 4.7 us at 3.35 TB/s) and the vectors.
// Design: a cooperative launch of one block per tile, all tiles in one
// resident wave (ops/midsmooth.mid_tile_plan: T ~ NB / SMs, ~128 KB of
// bf16 a block at n=96).  The block copies its tile into shared memory
// once, with asynchronous 16-byte copies (cp.async) that fly while it
// builds its tables, then runs every root from there; its own outputs'
// x, b and d also stay in shared memory.  Per root it stages the
// neighbour x values of its tile, xn[k, s2, t] = x[s2, p_t + doff_k] (0
// for a wrapped neighbour, through a table of source indices built once),
// so that the product reads only shared memory; a thread issues
// MID_BATCH loads before it stores any.  The product: a warp takes one
// task at a time (an offset k and the next `rw` rows s2 of its
// rectangle; the tasks' records are built once and the next one loads
// while the warp works), a lane one row of the task and one brick pair
// (t, t + 1), and keeps the sums of all slots s1 of its pair in
// registers (MAXBS of them, a template parameter).  It loads the values
// of slots s1 < r1_k at once, in a body of 8, 16, 24 or 32 slots picked
// by r1_k, which is the same for the whole warp: no lane diverges, and
// the lanes of a load read consecutive words.  The rows of a warp are
// added in row order with shuffles, then the warps' sums in warp order
// through shared memory: fixed order, no atomics, so a run is
// bit-reproducible.  x crosses blocks through global memory, one grid
// barrier per root; levels ping-pong through `out` and `tmp` (level_buf)
// so the last root lands in `out`.
//
// On n=96-shaped operands (H100 80GB HBM3, 700 W; chip_smoke.py
// --synthetic, PERF.md PR 7) a first build whose threads each owned five
// slots of a pair (a warp mixed slot groups, diverged on r1_k and left a
// quarter of its lanes idle) and copied with one load in flight a thread
// took 12.4 us a root; this one ~7.5 us, most of it the product, which
// issues its shared loads, bf16 widening and FMAs back to back.
#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define MID_MAX_TILE 64
#define MID_BATCH 8  // loads a thread issues before it stores them
#define MID_WARPS 16

// The launch plan (ops/midsmooth.MidTilePlan): bricks per tile, values
// per tile in the buffer, rows of a task, tasks.
struct MidTiling {
  int T, stride, rw, tasks;
};

// Shared bytes of a block (the plan's formula): the tile, the task
// records, the staged x and its source indices, the warps' sums, the
// block's own x, b and d.
template <typename V>
static long mid_smem(const MidGeom& g, const MidTiling& tl, int maxbs) {
  long X = 0;
  for (int k = 0; k < g.k; ++k) X += g.r2[k];
  return (long)tl.stride * sizeof(V) + 16L * tl.tasks + 8 * X * tl.T +
         4L * MID_WARPS * (tl.T / 2) * maxbs * 2 + 12L * g.bs * tl.T;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// bf16 to f32 is exact: the bf16 bits are the f32's upper half.
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// One task's rows of one lane: its row's x pair xv times the values of
// slots s1 < r1 (NS of them loaded at once, NS the least multiple of 8
// that covers r1 -- the same for the whole warp), into acc.
template <int NS, int MAXBS, typename V>
__device__ __forceinline__ void mid_task(float2 (&acc)[MAXBS], const V* A,
                                         int ss, float2 xv, bool ok,
                                         int r1) {
  if constexpr (NS < MAXBS) {
    if (r1 > NS) {
      mid_task<NS + 8, MAXBS>(acc, A, ss, xv, ok, r1);
      return;
    }
  }
  float2 av[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    av[s] = ok && s < r1 ? ld2(A + s * ss) : make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    acc[s].x += av[s].x * xv.x;
    acc[s].y += av[s].y * xv.y;
  }
}

template <typename V, bool RES, int MAXBS>
__global__ void __launch_bounds__(MID_WARPS * 32, 1)
    mid_chain_kernel(const V* __restrict__ tiles, MidGeom g, MidTiling tl,
                     Taus taus, const float* __restrict__ b,
                     const float* __restrict__ d, const float* x0,
                     float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int xoff[SAAMGE_MAX_BOFFS + 1];    // first xn row of offset k
  __shared__ int rmax;                          // max_k r1_k
  __shared__ int sdx[SAAMGE_MAX_BOFFS], sdy[SAAMGE_MAX_BOFFS],
      sdz[SAAMGE_MAX_BOFFS];  // the offsets, read with a runtime k
  const int NB = g.BX * g.BY * g.BZ, T = tl.T, P = T / 2, bs = g.bs;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * T;
  int X = 0;
  for (int k = 0; k < g.k; ++k) X += g.r2[k];
  const int XT = X * T, OT = bs * T;
  V* vals = reinterpret_cast<V*>(smem);
  // per task: its first xn row, its first tile row (slot 0), r1, and
  // r2 * 256 + its rows
  int4* task = reinterpret_cast<int4*>(smem + (long)tl.stride * sizeof(V));
  float* xn = reinterpret_cast<float*>(task + tl.tasks);
  int* xidx = reinterpret_cast<int*>(xn + XT);  // source of xn, or -1
  float* part = reinterpret_cast<float*>(xidx + XT);
  float* own_x = part + MID_WARPS * P * MAXBS * 2;
  float* own_b = own_x + OT;
  float* own_d = own_b + OT;

  // the tile, once, as asynchronous 16-byte copies that fly while the
  // block builds its tables and stages the first level's x
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        tiles + (long)blockIdx.x * tl.stride);
    uint4* dst = reinterpret_cast<uint4*>(vals);
    const int n16 = (int)((long)tl.stride * sizeof(V) / 16);
    for (int i = tid; i < n16; i += nthreads)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
  }
  // warp 0, lane k: offset k's first xn row, first tile row and first
  // task (prefix sums over the lanes), its task records and offsets
  if (warp == 0) {
    const bool on = lane < g.k;
    const int r1 = on ? g.r1[lane] : 0, r2 = on ? g.r2[lane] : 0;
    const int nt = r1 > 0 ? (r2 + tl.rw - 1) / tl.rw : 0;
    int x = r2, r = r1 * r2, n = nt, m = r1;
    for (int o = 1; o < 32; o <<= 1) {
      const int xo = __shfl_up_sync(0xffffffffu, x, o),
                ro = __shfl_up_sync(0xffffffffu, r, o),
                no = __shfl_up_sync(0xffffffffu, n, o);
      if (lane >= o) {
        x += xo;
        r += ro;
        n += no;
      }
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    x -= r2;  // exclusive
    r -= r1 * r2;
    n -= nt;
    if (on) {
      xoff[lane] = x;
      sdx[lane] = g.dx[lane];
      sdy[lane] = g.dy[lane];
      sdz[lane] = g.dz[lane];
      for (int j = 0; j < nt; ++j) {
        const int s = j * tl.rw;
        task[n + j] =
            make_int4(x + s, r + s, r1, r2 * 256 + min(tl.rw, r2 - s));
      }
    }
    if (lane == g.k - 1) xoff[g.k] = x + r2;
    if (lane == 0) rmax = m;
  }
  for (int i = tid; i < OT; i += nthreads) {
    const int p = p0 + i % T;
    const long gi = (long)(i / T) * NB + p;
    own_x[i] = p < NB ? x0[gi] : 0.f;
    own_b[i] = p < NB ? b[gi] : 0.f;
    own_d[i] = p < NB ? d[gi] : 0.f;
  }
  __syncthreads();
  // xn's source indices: thread (k, t) finds brick t's neighbour across
  // offset k, then writes the r2_k rows
  for (int i = tid; i < g.k * T; i += nthreads) {
    const int k = i / T, t = i % T, p = p0 + t;
    const int qx = p / (g.BY * g.BZ) + sdx[k], qy = (p / g.BZ) % g.BY + sdy[k],
              qz = p % g.BZ + sdz[k];
    const int q = p < NB && qx >= 0 && qx < g.BX && qy >= 0 && qy < g.BY &&
                          qz >= 0 && qz < g.BZ
                      ? (qx * g.BY + qy) * g.BZ + qz
                      : -1;
    for (int s2 = 0; s2 < xoff[k + 1] - xoff[k]; ++s2)
      xidx[(xoff[k] + s2) * T + t] = q >= 0 ? s2 * NB + q : -1;
  }

  const int row = lane / P, u = lane % P;
  const bool lane_on = row < tl.rw;
  const float* src = x0;
  const int L = taus.k + (RES ? 1 : 0);
  for (int r = 1; r <= L; ++r) {
    __syncthreads();  // xidx built; no thread still reads the last xn
    for (int i0 = tid; i0 < XT; i0 += MID_BATCH * nthreads) {
      float v[MID_BATCH];
#pragma unroll
      for (int j = 0; j < MID_BATCH; ++j) {
        const int i = i0 + j * nthreads;
        const int at = i < XT ? xidx[i] : -1;
        v[j] = at >= 0 ? src[at] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < MID_BATCH; ++j)
        if (i0 + j * nthreads < XT) xn[i0 + j * nthreads] = v[j];
    }
    if (r == 1) __pipeline_wait_prior(0);  // the tile has landed
    __syncthreads();
    float2 acc[MAXBS];
#pragma unroll
    for (int s1 = 0; s1 < MAXBS; ++s1) acc[s1] = make_float2(0.f, 0.f);
    int4 tk = warp < tl.tasks ? task[warp] : make_int4(0, 0, 0, 0);
    for (int c = warp; c < tl.tasks; c += MID_WARPS) {
      const int4 cur = tk;  // the next task's record loads meanwhile
      if (c + MID_WARPS < tl.tasks) tk = task[c + MID_WARPS];
      const bool ok = lane_on && row < (cur.w & 255);
      const float2 xv = ok ? ld2(xn + (cur.x + row) * T + 2 * u)
                           : make_float2(0.f, 0.f);
      // row (k, s1 = 0, s2) of the tile; slot s1 adds s1 r2 rows
      mid_task<8, MAXBS>(acc, vals + (cur.y + row) * T + 2 * u,
                         (cur.w >> 8) * T, xv, ok, cur.z);
    }
    // the warp's rows in row order, into lane (0, u)
    float2* pw = reinterpret_cast<float2*>(part) + (warp * P + u) * MAXBS;
#pragma unroll
    for (int s1 = 0; s1 < MAXBS; ++s1) {
      if (s1 < rmax) {
        float2 t = acc[s1];
        for (int j = 1; j < tl.rw; ++j) {
          t.x += __shfl_sync(0xffffffffu, acc[s1].x, u + j * P);
          t.y += __shfl_sync(0xffffffffu, acc[s1].y, u + j * P);
        }
        if (row == 0) pw[s1] = t;
      }
    }
    __syncthreads();
    // outputs (s1, t): the warps' sums in warp order, then the root or
    // the residual in the op order of the plain chain
    float* dst = r <= taus.k ? level_buf(r, taus.k, out, tmp) : res;
    const float it = r <= taus.k ? taus.inv_tau[r - 1] : 0.f;
    for (int i = tid; i < OT; i += nthreads) {
      const int s1 = i / T, t = i % T, p = p0 + t;
      if (p >= NB) continue;
      const int at = ((t / 2) * MAXBS + s1) * 2 + (t & 1);
      float ax = 0.f;  // slots past every rectangle: A1 x = 0
      if (s1 < rmax)
        for (int w = 0; w < MID_WARPS; ++w)
          ax += part[w * P * MAXBS * 2 + at];
      const long gi = (long)s1 * NB + p;
      if (r > taus.k) {
        dst[gi] = __fsub_rn(own_b[i], ax);
      } else {
        const float xv = __fadd_rn(
            own_x[i],
            __fmul_rn(__fmul_rn(own_d[i], __fsub_rn(own_b[i], ax)), it));
        own_x[i] = xv;
        dst[gi] = xv;
      }
    }
    if (r < L) grid.sync();
    src = dst;
  }
}

template <typename V, int MAXBS>
static cudaError_t launch_mid(const V* tiles, MidGeom g, MidTiling tl,
                              int tiles_n, int threads, int smem, Taus taus,
                              int emit_res, const float* b, const float* d,
                              const float* x0, float* out, float* tmp,
                              float* res, cudaStream_t stream) {
  const long NB = (long)g.BX * g.BY * g.BZ;
  long rows = 0;
  for (int k = 0; k < g.k; ++k) rows += (long)g.r1[k] * g.r2[k];
  if (tl.T < 2 || tl.T % 2 || tl.T > MID_MAX_TILE ||
      (long)tiles_n * tl.T < NB || (long)(tiles_n - 1) * tl.T >= NB ||
      tl.stride < rows * tl.T || (tl.stride * sizeof(V)) % 16 ||
      tl.rw != 32 / (tl.T / 2) || threads != MID_WARPS * 32 ||
      smem != mid_smem<V>(g, tl, MAXBS) || smem > 232448 ||
      (uintptr_t)tiles % 16)
    return cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&tiles, (void*)&g,   (void*)&tl,  (void*)&taus,
                  (void*)&b,     (void*)&d,   (void*)&x0,  (void*)&out,
                  (void*)&tmp,   (void*)&res};
  const void* func = emit_res
                         ? (const void*)mid_chain_kernel<V, true, MAXBS>
                         : (const void*)mid_chain_kernel<V, false, MAXBS>;
  return launch_cooperative_grid(func, tiles_n, threads, (size_t)smem, args,
                                 stream);
}

template <typename V>
static cudaError_t launch_mid_bs(const V* tiles, MidGeom g, MidTiling tl,
                                 const int* plan, Taus taus, int emit_res,
                                 const float* b, const float* d,
                                 const float* x0, float* out, float* tmp,
                                 float* res, cudaStream_t s) {
  // MAXBS: the slots a lane sums in registers, bs rounded up to 8
  switch ((g.bs + 7) / 8) {
    case 1:
      return launch_mid<V, 8>(tiles, g, tl, plan[4], plan[5], plan[6], taus,
                              emit_res, b, d, x0, out, tmp, res, s);
    case 2:
      return launch_mid<V, 16>(tiles, g, tl, plan[4], plan[5], plan[6], taus,
                               emit_res, b, d, x0, out, tmp, res, s);
    case 3:
      return launch_mid<V, 24>(tiles, g, tl, plan[4], plan[5], plan[6], taus,
                               emit_res, b, d, x0, out, tmp, res, s);
    case 4:
      return launch_mid<V, 32>(tiles, g, tl, plan[4], plan[5], plan[6], taus,
                               emit_res, b, d, x0, out, tmp, res, s);
  }
  return cudaErrorInvalidConfiguration;
}

// geom: BX, BY, BZ, bs, then per offset (dx, dy, dz, r1, r2).  plan:
// T, stride, rows of a task, tasks, tiles, threads, shared bytes
// (ops/midsmooth.MidTilePlan.ints).
extern "C" int saamge_mid_chain(const void* tiles, int tiles_bf16,
                                const int* geom, int n_offs, const int* plan,
                                const float* inv_taus, int n_roots,
                                int emit_res, const float* b, const float* d,
                                const float* x0, float* out, float* tmp,
                                float* res, void* stream) {
  if (n_offs < 1 || n_offs > SAAMGE_MAX_BOFFS || n_roots < 1 ||
      n_roots > SAAMGE_MAX_ROOTS)
    return (int)cudaErrorInvalidValue;
  MidGeom g = make_mid_geom(geom, n_offs);
  if (g.bs < 1 || g.bs > 32) return (int)cudaErrorInvalidValue;
  MidTiling tl = {plan[0], plan[1], plan[2], plan[3]};
  if (tl.rw < 1) return (int)cudaErrorInvalidConfiguration;
  int tasks = 0;
  for (int k = 0; k < n_offs; ++k) {
    if (g.r1[k] < 0 || g.r1[k] > g.bs || g.r2[k] < 0 || g.r2[k] > g.bs)
      return (int)cudaErrorInvalidValue;
    if (g.r1[k] > 0) tasks += (g.r2[k] + tl.rw - 1) / tl.rw;
  }
  if (tl.tasks != tasks) return (int)cudaErrorInvalidConfiguration;
  Taus taus = make_taus(inv_taus, n_roots);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      tiles_bf16
          ? launch_mid_bs((const __nv_bfloat16*)tiles, g, tl, plan, taus,
                          emit_res, b, d, x0, out, tmp, res, s)
          : launch_mid_bs((const float*)tiles, g, tl, plan, taus, emit_res,
                          b, d, x0, out, tmp, res, s);
  return (int)e;
}
