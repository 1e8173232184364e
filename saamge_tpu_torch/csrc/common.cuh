// Shared pieces of the port's Hopper kernels: value loads (single and
// paired) that widen bf16 to f32, the small kernel-argument structs, the
// once-per-kernel shared-memory limit, and the cooperative launch used by
// the chained (multi-level) kernels.  Every launcher is capturable in a
// CUDA graph: it launches on the stream it is given and, after a kernel's
// first use, makes no attribute or occupancy call.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#define SAAMGE_MAX_DIAGS 64
#define SAAMGE_MAX_ROOTS 32
#define SAAMGE_MAX_BOFFS 27
#define SAAMGE_THREADS 256

// Stencil offsets (row-aligned DIA: vals[k, i] = A[i, i + off[k]]).
struct Offsets {
  int k;
  int off[SAAMGE_MAX_DIAGS];
};

// 1 / tau of each chained root.
struct Taus {
  int k;
  float inv_tau[SAAMGE_MAX_ROOTS];
};

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// The values at i and i + 1 (the second only when `second`, else 0),
// widened to f32.  VEC: one 2-wide load, for an i whose address is
// aligned to two values.
struct Pair {
  float a, b;
};
template <bool VEC>
__device__ __forceinline__ Pair ld_pair(const float* p, long i, bool second) {
  if (VEC) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    return {v.x, v.y};
  }
  return {p[i], second ? p[i + 1] : 0.f};
}
template <bool VEC>
__device__ __forceinline__ Pair ld_pair(const __nv_bfloat16* p, long i,
                                        bool second) {
  if (VEC) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + i));
    return {v.x, v.y};
  }
  return {__bfloat162float(p[i]), second ? __bfloat162float(p[i + 1]) : 0.f};
}

// (A x)[i] of a row-aligned DIA operator; x is haloed and t = i + halo.
// Taps are summed in offset order, as the plain versions do.  x is not
// __restrict__: the chained kernels rewrite it between grid barriers, so
// its loads must not take the non-coherent read-only path.
template <typename V>
__device__ __forceinline__ float stencil_row(const V* __restrict__ vals,
                                             const Offsets& offs, long n,
                                             long i, const float* x,
                                             long t) {
  float ax = 0.f;
  for (int k = 0; k < offs.k; ++k)
    ax += ld(vals, (long)k * n + i) * x[t + offs.off[k]];
  return ax;
}

// Brick-block mid operator geometry (midsmooth.cu, midmv.cu): the brick
// grid, the slot count, and per brick offset (dx, dy, dz) its used-slot
// rectangle (r1, r2).
struct MidGeom {
  int BX, BY, BZ, bs, k;
  int dx[SAAMGE_MAX_BOFFS], dy[SAAMGE_MAX_BOFFS], dz[SAAMGE_MAX_BOFFS];
  int r1[SAAMGE_MAX_BOFFS], r2[SAAMGE_MAX_BOFFS];
};

// geom: BX, BY, BZ, bs, then per offset (dx, dy, dz, r1, r2); the caller
// checks 1 <= k <= SAAMGE_MAX_BOFFS.
static inline MidGeom make_mid_geom(const int* geom, int k) {
  MidGeom g;
  g.BX = geom[0];
  g.BY = geom[1];
  g.BZ = geom[2];
  g.bs = geom[3];
  g.k = k;
  for (int j = 0; j < k; ++j) {
    const int* o = geom + 4 + 5 * j;
    g.dx[j] = o[0];
    g.dy[j] = o[1];
    g.dz[j] = o[2];
    g.r1[j] = o[3];
    g.r2[j] = o[4];
  }
  return g;
}

// Brick q = p + doff_k of brick p, or -1 when it leaves the brick grid.
__device__ __forceinline__ int mid_neighbour(const MidGeom& g, int k, int px,
                                             int py, int pz) {
  const int qx = px + g.dx[k], qy = py + g.dy[k], qz = pz + g.dz[k];
  if (qx < 0 || qx >= g.BX || qy < 0 || qy >= g.BY || qz < 0 || qz >= g.BZ)
    return -1;
  return (qx * g.BY + qy) * g.BZ + qz;
}

static inline Offsets make_offsets(const int* off, int k) {
  Offsets o;
  o.k = k;
  for (int i = 0; i < k; ++i) o.off[i] = off[i];
  return o;
}

static inline Taus make_taus(const float* inv_tau, int k) {
  Taus t;
  t.k = k;
  for (int i = 0; i < k; ++i) t.inv_tau[i] = inv_tau[i];
  return t;
}

// Level r's output buffer of a chain of k roots (1 <= r <= k): levels
// ping-pong between `out` and `tmp` so that the last root (r = k) lands
// in `out` and no level writes the buffer it reads.
__device__ __forceinline__ float* level_buf(int r, int k, float* out,
                                            float* tmp) {
  return ((k - r) % 2 == 0) ? out : tmp;
}

// Launch-time state that is a property of the kernel and the card, not of
// a call: the dynamic shared-memory limit a kernel was given and its
// cooperative capacity.  Both are set or queried at a kernel's first use
// (an eager launch, before any CUDA-graph capture) and read from these
// tables after, so that a launch being captured makes no attribute or
// occupancy call, and a replay, which re-checks nothing, runs the grid
// that was checked when it was recorded.
struct LaunchKey {
  const void* func;
  int dev, threads;
  size_t smem;
  bool operator<(const LaunchKey& o) const {
    return std::tie(func, dev, threads, smem) <
           std::tie(o.func, o.dev, o.threads, o.smem);
  }
};

static inline std::mutex& launch_table_lock() {
  static std::mutex m;
  return m;
}

// Raise `func`'s dynamic shared-memory limit on the current card to at
// least `smem` (once per kernel and card; a larger later request raises
// it again).
static inline cudaError_t smem_limit(const void* func, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::map<std::pair<const void*, int>, size_t> limits;
  std::lock_guard<std::mutex> guard(launch_table_lock());
  auto it = limits.find({func, dev});
  if (it != limits.end() && it->second >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  limits[{func, dev}] = smem;
  return cudaSuccess;
}

// Blocks of `func` (`threads` threads, `smem` dynamic shared bytes) that
// can be resident at once on the whole card: the occupancy query times the
// SMs, made once per (kernel, card, threads, smem).
static inline cudaError_t cooperative_capacity(const void* func, int threads,
                                               size_t smem, long* capacity) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::map<LaunchKey, long> known;
  const LaunchKey key{func, dev, threads, smem};
  {
    std::lock_guard<std::mutex> guard(launch_table_lock());
    auto it = known.find(key);
    if (it != known.end()) {
      *capacity = it->second;
      return cudaSuccess;
    }
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = smem_limit(func, smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, func, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  *capacity = (long)per_sm * sms;
  std::lock_guard<std::mutex> guard(launch_table_lock());
  known[key] = *capacity;
  return cudaSuccess;
}

// One cooperative launch through cudaLaunchKernelExC with the cooperative
// launch attribute: the same launch as cudaLaunchCooperativeKernel, in
// the form that stream capture records as a cooperative kernel node.
static inline cudaError_t launch_cooperative_ex(const void* func, long grid,
                                                int threads, size_t smem,
                                                void** args,
                                                cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelExC(&cfg, func, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launch `func` cooperatively with exactly `grid` blocks, so that
// grid-wide barriers are legal.  A grid larger than one resident wave is
// refused with cudaErrorCooperativeLaunchTooLarge; nothing falls back.
static inline cudaError_t launch_cooperative_grid(const void* func,
                                                  long grid, int threads,
                                                  size_t smem, void** args,
                                                  cudaStream_t stream) {
  long capacity = 0;
  cudaError_t e = cooperative_capacity(func, threads, smem, &capacity);
  if (e != cudaSuccess) return e;
  if (grid < 1 || grid > capacity) return cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative_ex(func, grid, threads, smem, args, stream);
}

// Launch `func` cooperatively with as many blocks as can be resident at
// once, capped by the work (`work` items of one thread each); the kernel
// loops over its work.
static inline cudaError_t launch_cooperative(const void* func, long work,
                                             void** args,
                                             cudaStream_t stream,
                                             int threads = SAAMGE_THREADS,
                                             size_t smem = 0) {
  long capacity = 0;
  cudaError_t e = cooperative_capacity(func, threads, smem, &capacity);
  if (e != cudaSuccess) return e;
  if (capacity < 1) return cudaErrorCooperativeLaunchTooLarge;
  long grid = (work + threads - 1) / threads;
  if (grid > capacity) grid = capacity;
  if (grid < 1) grid = 1;
  return launch_cooperative_ex(func, grid, threads, smem, args, stream);
}
