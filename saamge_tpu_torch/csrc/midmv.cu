// Kernel 6: one pass of the mid level's brick-block operator over the
// packed per-offset used-slot rectangles (the operator stored without its
// structurally zero slot pairs), in three modes:
//   spmv      y = A1 x
//   residual  y = b - A1 x
//   root      y = x + dinv * (b - A1 x) * inv_tau
// with the op order of the JAX chain x1 + dinv1 * (b1 - A x1) * it
// (saamge_tpu/solve/structured.py mid_correct); the epilogue uses _rn
// intrinsics so that nvcc does not contract it into an FMA.
//
// Operator (slot-major padded layout, coarse dof (p, s) at s * NB + p):
//   packed[start_k + (s1 * r2_k + s2) * NB + p] = A1[(p, s1), (p + doff_k, s2)]
// for s1 < r1_k, s2 < r2_k; start_k = sum_{j<k} r1_j r2_j NB.  Output
// slots s1 outside every rectangle (the padding slots) get A1 x = 0.
//
// Replaces: saamge_tpu/ops/pallas_midmv.py `_build_chunked_mv` (the
// lane-chunked streamed Pallas matvec behind chunked_matvec).
//
// Differences from the TPU kernel, on purpose:
//  * its lane chunking (chunk_plan, Lc, nside, the 16-row sublane padding)
//    is a VMEM budget and is not ported.
//  * the neighbour brick p + doff is computed from (px, py, pz) with an
//    explicit bounds check (mid_neighbour); the TPU kernel shifts lanes
//    across x-slabs and relies on structurally zero block entries at the
//    wrapped lanes.  Here a wrapped lane reads x as 0, as the plain
//    version's zero pad does, whatever its block holds.
//  * bf16 blocks are widened to f32 and multiplied by the f32 x in f32
//    (the TPU kernel rounds x and each product to bf16).
//
// Bound on this card: bytes, the packed blocks read once per pass (15.8
// MB of bf16 at the n=96 capacity point, 4.8 us at 3.35 TB/s).
// Design.  The first version (one thread per output, each walking 27
// offsets x r2 slots in one dependent chain, 34,560 threads at n=96) was
// bound by latency: 75.5 us in the capacity cycle.  Here a block owns a
// tile of MIDMV_TILE consecutive bricks, two per lane, and MIDMV_SLOTS
// consecutive output slots, so each block row is one 4-byte bf16x2
// (8-byte float2) load per lane, 128 (256) contiguous bytes per warp.
// The block lists its tasks in shared memory (a task: up to MIDMV_TASK
// consecutive rows s2 of one offset k; a warp prefix sum over the
// offsets numbers them); its warps take the tasks round-robin.  A task
// finds its neighbour bricks and loads its x values once for all the
// block's slots, and issues all its block loads before summing: the
// first designs of this kernel (a block per slot, the offset or row loop
// per warp) were bound by instruction issue, ~10 instructions of address
// arithmetic and tests per loaded value, so the fast path of a full task
// is written with pointer strides and no per-value test.  The warps sum
// their partials through shared memory in warp order: fixed order, no
// atomics, so a run is bit-reproducible.  At n=96 that is 27 x 4 blocks
// of 16 warps, one per SM.  x (138 KB) is left to L1/L2, not staged: a
// block reads only the rows s2 < r2 at the neighbours of its tile, and
// the 27 offsets re-read the same lines, so L1 serves them; staging all
// of x would cap the SM at one small block.  Tile, warps, grid and shared
// bytes come from ops/midmv.midmv_plan.
//
// Time at the n=96 capacity shapes (H100 80GB HBM3, 700 W; chip_smoke.py
// device_ms): 11.7 us per call against 16.3 us for the CSR product of the
// same operator; 14.1 us in the capacity cycle (chip_profile.py).
// PERF.md section 6, row 7.
#include <stdint.h>

#include "common.cuh"

#define MIDMV_TILE 64  // bricks per block: 32 lanes x 2
#define MIDMV_SLOTS 5  // output slots per block
#define MIDMV_TASK 4   // rows (s2) of one offset a warp takes at once

struct PackedStarts {
  long start[SAAMGE_MAX_BOFFS];
};

// Shared bytes of a block (the plan's formula, ops/midmv.midmv_plan):
// the task list and the warps' partial sums.
static long midmv_smem(const MidGeom& g, int warps) {
  long tasks = 0;
  for (int k = 0; k < g.k; ++k)
    tasks += (g.r2[k] + MIDMV_TASK - 1) / MIDMV_TASK;
  return 4 * (tasks + (long)warps * MIDMV_SLOTS * MIDMV_TILE);
}

// mode: 0 spmv, 1 residual, 2 root (MODES of ops/midmv.py).  VEC: 2-wide
// loads.
template <typename V, bool VEC>
__global__ void midmv_kernel(const V* __restrict__ packed, MidGeom g,
                             PackedStarts st, const float* __restrict__ x,
                             const float* __restrict__ b,
                             const float* __restrict__ dinv, float inv_tau,
                             int mode, float* __restrict__ y) {
  // dynamic: [sum_k ceil(r2_k / MIDMV_TASK)] task codes (k << 16 | c),
  // then [warps][MIDMV_SLOTS][MIDMV_TILE] partial sums
  extern __shared__ int tasks[];
  __shared__ int task0[SAAMGE_MAX_BOFFS + 1];
  const int NB = g.BX * g.BY * g.BZ;
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int sa = blockIdx.y * MIDMV_SLOTS;  // the block's first slot
  int max_tasks = 0;
  for (int k = 0; k < g.k; ++k)
    max_tasks += (g.r2[k] + MIDMV_TASK - 1) / MIDMV_TASK;
  float* part = reinterpret_cast<float*>(tasks + max_tasks);

  // the tasks of the block's slots: offsets k with sa < r1_k, each with
  // its r2_k rows in tasks of MIDMV_TASK, numbered by a prefix sum
  if (w == 0) {
    int n = (lane < g.k && sa < g.r1[lane])
                ? (g.r2[lane] + MIDMV_TASK - 1) / MIDMV_TASK
                : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int m = __shfl_up_sync(0xffffffffu, n, o);
      if (lane >= o) n += m;
    }
    if (lane < g.k) task0[lane + 1] = n;
    if (lane == 0) task0[0] = 0;
  }
  __syncthreads();
  for (int k = w; k < g.k; k += warps)
    for (int c = lane; c < task0[k + 1] - task0[k]; c += 32)
      tasks[task0[k] + c] = (k << 16) | c;
  __syncthreads();
  const int n_tasks = task0[g.k];

  const int p0 = blockIdx.x * MIDMV_TILE + 2 * lane;
  const bool ok0 = p0 < NB, ok1 = p0 + 1 < NB;
  const int c0[3] = {p0 / (g.BY * g.BZ), (p0 / g.BZ) % g.BY, p0 % g.BZ};
  const int c1[3] = {(p0 + 1) / (g.BY * g.BZ), ((p0 + 1) / g.BZ) % g.BY,
                     (p0 + 1) % g.BZ};
  // warp w takes tasks w, w + warps, ...; a task's neighbours and x
  // values are loaded once and serve all the block's slots s < r1_k.  A
  // full task (MIDMV_TASK rows, MIDMV_SLOTS slots) loads all its values
  // before summing them, with pointer strides and no per-value test; an
  // offset's last rows and its last slots take the general loop.  A
  // wrapped neighbour reads x as 0, as the plain version's zero pad.
  float acc[MIDMV_SLOTS][2] = {};
  for (int j = w; ok0 && j < n_tasks; j += warps) {
    const int k = tasks[j] >> 16, s20 = (tasks[j] & 0xffff) * MIDMV_TASK;
    const int r2 = g.r2[k], ns = min(MIDMV_SLOTS, g.r1[k] - sa),
              nr = min(MIDMV_TASK, r2 - s20);
    const int q0 = mid_neighbour(g, k, c0[0], c0[1], c0[2]);
    const int q1 = ok1 ? mid_neighbour(g, k, c1[0], c1[1], c1[2]) : -1;
    const float m0 = q0 >= 0 ? 1.f : 0.f, m1 = q1 >= 0 ? 1.f : 0.f;
    const float* X0 = x + (long)s20 * NB + (q0 >= 0 ? q0 : p0);
    const float* X1 = x + (long)s20 * NB + (q1 >= 0 ? q1 : p0);
    const V* B = packed + st.start[k] + ((long)sa * r2 + s20) * NB + p0;
    const long rs = (long)r2 * NB;  // slot stride
    if (nr == MIDMV_TASK && ns == MIDMV_SLOTS) {
      float x0[MIDMV_TASK], x1[MIDMV_TASK];
      Pair v[MIDMV_SLOTS][MIDMV_TASK];
#pragma unroll
      for (int u = 0; u < MIDMV_TASK; ++u) {
        x0[u] = X0[u * NB];
        x1[u] = X1[u * NB];
      }
#pragma unroll
      for (int sl = 0; sl < MIDMV_SLOTS; ++sl) {
        const V* Bs = B + sl * rs;
#pragma unroll
        for (int u = 0; u < MIDMV_TASK; ++u)
          v[sl][u] = ld_pair<VEC>(Bs, u * NB, ok1);
      }
#pragma unroll
      for (int u = 0; u < MIDMV_TASK; ++u) {
        const float xa = x0[u] * m0, xb = x1[u] * m1;
#pragma unroll
        for (int sl = 0; sl < MIDMV_SLOTS; ++sl) {
          acc[sl][0] += v[sl][u].a * xa;
          acc[sl][1] += v[sl][u].b * xb;
        }
      }
    } else {
      for (int u = 0; u < nr; ++u) {
        const float xa = X0[u * NB] * m0, xb = X1[u * NB] * m1;
#pragma unroll
        for (int sl = 0; sl < MIDMV_SLOTS; ++sl) {
          if (sl < ns) {
            const Pair q = ld_pair<VEC>(B + sl * rs, u * NB, ok1);
            acc[sl][0] += q.a * xa;
            acc[sl][1] += q.b * xb;
          }
        }
      }
    }
  }
#pragma unroll
  for (int sl = 0; sl < MIDMV_SLOTS; ++sl) {
    float* pp = part + (w * MIDMV_SLOTS + sl) * MIDMV_TILE + 2 * lane;
    pp[0] = acc[sl][0];
    pp[1] = acc[sl][1];
  }
  __syncthreads();
  const int ns = min(MIDMV_SLOTS, g.bs - sa);
  for (int t = threadIdx.x; t < ns * MIDMV_TILE; t += blockDim.x) {
    const int sl = t / MIDMV_TILE, tp = t % MIDMV_TILE;
    const int p = blockIdx.x * MIDMV_TILE + tp;
    if (p >= NB) continue;
    float ax = 0.f;
    for (int j = 0; j < warps; ++j)
      ax += part[(j * MIDMV_SLOTS + sl) * MIDMV_TILE + tp];
    const long i = (long)(sa + sl) * NB + p;
    float out = ax;
    if (mode == 1) {
      out = __fsub_rn(b[i], ax);
    } else if (mode == 2) {
      out = __fadd_rn(
          x[i], __fmul_rn(__fmul_rn(dinv[i], __fsub_rn(b[i], ax)), inv_tau));
    }
    y[i] = out;
  }
}

template <typename V, bool VEC>
static cudaError_t launch_midmv_as(const V* packed, const MidGeom& g,
                                   const PackedStarts& st, const float* x,
                                   const float* b, const float* dinv,
                                   float inv_tau, int mode, float* y,
                                   const int* plan, cudaStream_t stream) {
  cudaError_t e = smem_limit((const void*)midmv_kernel<V, VEC>, plan[3]);
  if (e != cudaSuccess) return e;
  midmv_kernel<V, VEC><<<dim3(plan[1], plan[2]), plan[0], plan[3], stream>>>(
      packed, g, st, x, b, dinv, inv_tau, mode, y);
  return cudaGetLastError();
}

template <typename V>
static cudaError_t launch_midmv(const V* packed, const MidGeom& g,
                                const PackedStarts& st, const float* x,
                                const float* b, const float* dinv,
                                float inv_tau, int mode, float* y,
                                const int* plan, cudaStream_t stream) {
  const long NB = (long)g.BX * g.BY * g.BZ;
  const int threads = plan[0];
  if (threads < 32 || threads > 1024 || threads % 32 ||
      (long)plan[1] * MIDMV_TILE < NB ||
      plan[2] != (g.bs + MIDMV_SLOTS - 1) / MIDMV_SLOTS ||
      plan[3] != midmv_smem(g, threads / 32) || plan[3] > 232448)
    return cudaErrorInvalidConfiguration;
  // 2-wide loads need every row start p0 of a lane even
  const bool vec = NB % 2 == 0 && (uintptr_t)packed % (2 * sizeof(V)) == 0;
  return vec ? launch_midmv_as<V, true>(packed, g, st, x, b, dinv, inv_tau,
                                        mode, y, plan, stream)
             : launch_midmv_as<V, false>(packed, g, st, x, b, dinv, inv_tau,
                                         mode, y, plan, stream);
}

// geom as saamge_mid_chain's: BX, BY, BZ, bs, then per offset
// (dx, dy, dz, r1, r2).  plan: threads, grid x, grid y, shared bytes
// (ops/midmv.midmv_plan).  b and dinv may be null where the mode does not
// read them.
extern "C" int saamge_midmv(int mode, const void* packed, int packed_bf16,
                            const int* geom, int n_offs, const int* plan,
                            const float* x, const float* b,
                            const float* dinv, float inv_tau, float* y,
                            void* stream) {
  if (n_offs < 1 || n_offs > SAAMGE_MAX_BOFFS || mode < 0 || mode > 2 ||
      (mode >= 1 && b == nullptr) || (mode == 2 && dinv == nullptr))
    return (int)cudaErrorInvalidValue;
  MidGeom g = make_mid_geom(geom, n_offs);
  const long NB = (long)g.BX * g.BY * g.BZ;
  PackedStarts st;
  long at = 0;
  for (int k = 0; k < n_offs; ++k) {
    if (g.r1[k] < 0 || g.r1[k] > g.bs || g.r2[k] < 0 || g.r2[k] > g.bs)
      return (int)cudaErrorInvalidValue;
    st.start[k] = at;
    at += (long)g.r1[k] * g.r2[k] * NB;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      packed_bf16
          ? launch_midmv((const __nv_bfloat16*)packed, g, st, x, b, dinv,
                         inv_tau, mode, y, plan, s)
          : launch_midmv((const float*)packed, g, st, x, b, dinv, inv_tau,
                         mode, y, plan, s);
  return (int)e;
}
