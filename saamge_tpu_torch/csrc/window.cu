// Kernel 3: the tent restriction R and prolongation P between the fine
// node grid and the slot-major padded coarse layout (coarse dof
// (brick p, slot s) at s * NB + p).
//
//   R:  yc[s, p] = sum_w Rst[s, w, p] * r[window(p, w)]
//   P:  y[g]     = sum over bricks p whose closed box holds node g of
//                  sum_s Rst[s, w(p, g), p] * xc[s, p]
//
// where window(p, w) is node w of brick p's closed (bx+1)(by+1)(bz+1)
// box.  Rst is the slot-major (bs, box, NB) tent array, f32 or bf16.
//
// Replaces: saamge_tpu/ops/pallas_window.py `_build_window_R` and
// `_build_window_P` (+ the XLA overlap-add fold_pieces).  The TPU kernels
// window z with 0/1 selection matmuls on the MXU and so truncate window
// values and per-slot partial sums to bf16; here the windows are plain
// index arithmetic, Rst is widened to f32 and r, xc and all sums stay
// f32 -- the numerics of the XLA apply_R / apply_P with a bf16 Rst.
//
// Bound on this card: device-memory bytes of Rst (bs x 729 x NB values,
// 50 MB in bf16 at the n=96 flagship, 15 us at 3.35 TB/s) read once per
// apply.
// Design.  R: the first version (one thread per (s, p), each walking the
// 729 box nodes in one dependent chain, node reads 8 floats apart) ran at
// 0.44 TB/s, 120 us in the flagship cycle.  Here a block owns one z-line
// of bricks (BZ consecutive bricks p) and WINDOW_R_SG slots.  It stages
// once, in dynamic shared memory, the nodes the z-line's boxes cover
// ((bx+1) x (by+1) rows of NZn f32, 41 KB at n=96 with the partials, so
// five blocks fit an SM), and all its slots read nodes from shared memory
// instead of L1/L2.  A staged row puts node gz at gz + gz / bz: brick
// pz's node z sits at pz (bz+1) + z + z / bz, so neighbouring bricks fall
// bz+1 (odd) floats apart, in other banks.  A warp stages four rows at a
// time with all their loads in flight.  The 729-term sum is split over
// the box's x-planes u and over vs ranges of its y-rows v: a thread takes
// (u, v-range, brick pair) for all the block's slots, so each node read
// from shared memory serves WINDOW_R_SG slots, and loads a whole row's
// (bz+1) x WINDOW_R_SG Rst pairs (4-byte bf16x2, 8-byte float2) before it
// sums them, consecutive threads on consecutive brick pairs.  Those
// partial sums are added in (u, range) order through shared memory:
// fixed order, no atomics.  Two z-lines per block (48-byte Rst runs) and
// other vs measured slower (PERF.md).  vs, threads, grid, pitch and
// shared bytes come from ops/window.window_R_plan; the launcher checks
// them and the 232,448-byte limit, and returns the CUDA error of a
// refused launch.
// P (gather form, no atomics): one thread per fine node, visiting the
// <= 8 bricks whose closed box holds it -- along each axis coordinate g
// lies in brick g/b at local g%b, and also in brick g/b - 1 at local b
// when g%b == 0 and g > 0.  Threads are ordered so that consecutive
// threads take the same local z in consecutive z-bricks, which keeps
// the table, Rst and xc reads coalesced.  Shared planes are summed, so
// the overlap-add of fold_pieces disappears.  A node lies in exactly one
// MIS, whose coarse dofs hold consecutive slots of its master brick, so
// the nonzeros of Rst[:, w, p] are one slot range [lo, hi), mostly
// empty (ops/window.slot_ranges, a (2, box, NB) uint8 table): a node
// reads about 1.1 Rst values instead of ~1.38 bricks x bs = 28.  Terms
// are added in the dense loop's order, skipping only slots outside the
// range, and offsets are 32-bit (the launcher checks they fit).
//
// Times at n=96 (H100 80GB HBM3, 700 W; chip_smoke.py device_ms): R
// 34.5 us per call against 45.2 us for the CSR product of the same tent
// operator; P 18.2 us against 29.6 us (80.0 us with the dense slot
// loop).  PERF.md section 6, rows 3 and 4.
#include <stdint.h>

#include "common.cuh"

struct WinGeom {
  int BX, BY, BZ;  // bricks per axis
  int bx, by, bz;  // elements per brick per axis
  int bs;          // slots per brick
};

#define WINDOW_R_SG 4         // slots a window R block sums (ops/window.py)
#define WINDOW_R_THREADS 256  // most threads of a window R block
#define WINDOW_R_STAGE 4    // node rows a warp stages at once
#define WINDOW_R_ZCHUNKS 4  // 32-node chunks of a z-line staged at once

// Shared floats of window R: the node slab, (bx+1) x (by+1) rows of
// `pitch` floats, and the partial sums SG x (bx+1) x vs x (2 * brick
// pairs) (the plan's formula, ops/window.window_R_plan).
static long window_R_smem_floats(const WinGeom& g, int vs, int pitch) {
  const long pairs = (g.BZ + 1) / 2;
  return (long)(g.bx + 1) * (g.by + 1) * pitch +
         (long)WINDOW_R_SG * (g.bx + 1) * vs * 2 * pairs;
}

// Two values of V in one load, and their widening to f32: the fast path
// of window R keeps its loaded Rst pairs in this form until it sums
// them, half the registers of widened pairs.
template <typename V>
struct Wide2;
template <>
struct Wide2<float> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Wide2<__nv_bfloat16> {
  using T = __nv_bfloat162;
  __device__ static T zero() { return __float2bfloat162_rn(0.f); }
};
__device__ __forceinline__ float2 widen2(float2 v) { return v; }
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// ZE: the brick's z-extent bz when it is a compile-time constant (the
// z loop unrolls fully), else 0.
template <typename V, bool VEC, int ZE>
__global__ void __launch_bounds__(WINDOW_R_THREADS, 3)
    window_R_kernel(const V* __restrict__ Rst, WinGeom g, int vs, int pitch,
                    const float* __restrict__ r, float* __restrict__ yc) {
  extern __shared__ float sm[];
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int bx = g.bx, by = g.by, bz = ZE ? ZE : g.bz;
  const int NB = g.BX * g.BY * g.BZ;
  const int px = blockIdx.x / g.BY, py = blockIdx.x % g.BY;
  const int pairs = (g.BZ + 1) / 2;        // brick pairs of the z-line
  const int s0 = blockIdx.y * WINDOW_R_SG;
  const int ns = min(WINDOW_R_SG, g.bs - s0);
  const int p0 = blockIdx.x * g.BZ;        // first brick of the z-line
  const long NYn = (long)g.BY * by + 1, NZn = (long)g.BZ * bz + 1;
  // slab [bx+1][by+1][pitch]: node gz of row (u, v) at gz + gz / bz, so
  // that brick pz's node z sits at pz (bz+1) + z + z / bz, and
  // neighbouring bricks fall bz+1 floats (odd for even bz) apart, in
  // other banks
  float* slab = sm;
  float* part = sm + (bx + 1) * (by + 1) * pitch;  // [SG][bx+1][vs][2 pairs]

  // stage the z-line's nodes: a warp takes WINDOW_R_STAGE consecutive
  // node rows (u, v) at a time, the lanes along z, and loads all their
  // values before storing any (the loads are the latency)
  const int nz = (int)NZn, rows = (bx + 1) * (by + 1);
  for (int rv0 = w * WINDOW_R_STAGE; rv0 < rows;
       rv0 += warps * WINDOW_R_STAGE) {
    const float* src[WINDOW_R_STAGE];
    float* dst[WINDOW_R_STAGE];
#pragma unroll
    for (int i = 0; i < WINDOW_R_STAGE; ++i) {
      const int rv = min(rv0 + i, rows - 1), u = rv / (by + 1),
                v = rv - u * (by + 1);
      src[i] = r + ((long)(px * bx + u) * NYn + (long)py * by + v) * NZn;
      dst[i] = rv0 + i < rows ? slab + rv * pitch : nullptr;
    }
    for (int z0 = lane; z0 < nz; z0 += 32 * WINDOW_R_ZCHUNKS) {
      float val[WINDOW_R_STAGE][WINDOW_R_ZCHUNKS];
#pragma unroll
      for (int i = 0; i < WINDOW_R_STAGE; ++i)
#pragma unroll
        for (int c = 0; c < WINDOW_R_ZCHUNKS; ++c)
          val[i][c] = z0 + 32 * c < nz ? src[i][z0 + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < WINDOW_R_STAGE; ++i)
#pragma unroll
        for (int c = 0; c < WINDOW_R_ZCHUNKS; ++c) {
          const int gz = z0 + 32 * c;
          if (dst[i] != nullptr && gz < nz) dst[i][gz + gz / bz] = val[i][c];
        }
    }
  }
  __syncthreads();

  // a thread takes (box x-plane u, v-range vi, brick pair) for all the
  // block's slots: each node read from shared memory serves them all
  const long box = (long)(bx + 1) * (by + 1) * (bz + 1);
  const long sstride = box * NB;  // slot stride of Rst
  const int vlen = (by + 1 + vs - 1) / vs;
  for (int it = threadIdx.x; it < (bx + 1) * vs * pairs; it += blockDim.x) {
    const int pr = it % pairs, vi = (it / pairs) % vs, u = it / (pairs * vs);
    const int b0 = 2 * pr;
    const bool ok1 = b0 + 1 < g.BZ;
    // slab offsets of the two bricks; an absent second brick reads the
    // first's nodes times zero values
    const int o0 = b0 * (bz + 1), o1 = ok1 ? o0 + bz + 1 : o0;
    const int v1 = min(by + 1, (vi + 1) * vlen);
    const float* S = slab + (u * (by + 1) + vi * vlen) * pitch;
    const long w0 = (long)(u * (by + 1) + vi * vlen) * (bz + 1);
    const V* R = Rst + (s0 * box + w0) * NB + p0 + b0;
    float acc[WINDOW_R_SG][2] = {};
    bool fast = false;
    if constexpr (VEC && ZE > 0) {
      if (ns == WINDOW_R_SG) {
        // a row's (bz+1) x SG Rst pairs and its nodes are all loaded
        // before they are used
        using W2 = typename Wide2<V>::T;
        fast = true;
        const int ss = (int)sstride;  // the launcher checks it fits
        for (int v = vi * vlen; v < v1; ++v, S += pitch, R += (ZE + 1) * NB) {
          W2 wr[ZE + 1][WINDOW_R_SG];
#pragma unroll
          for (int z = 0; z <= ZE; ++z)
#pragma unroll
            for (int sl = 0; sl < WINDOW_R_SG; ++sl)
              wr[z][sl] = *reinterpret_cast<const W2*>(R + (z * NB + sl * ss));
          float n0[ZE + 1], n1[ZE + 1];
#pragma unroll
          for (int z = 0; z <= ZE; ++z) {
            n0[z] = S[o0 + z + z / ZE];
            n1[z] = S[o1 + z + z / ZE];
          }
#pragma unroll
          for (int z = 0; z <= ZE; ++z)
#pragma unroll
            for (int sl = 0; sl < WINDOW_R_SG; ++sl) {
              const float2 f = widen2(wr[z][sl]);
              acc[sl][0] += f.x * n0[z];
              acc[sl][1] += f.y * n1[z];
            }
        }
      }
    }
    for (int v = vi * vlen; !fast && v < v1; ++v, S += pitch)
      for (int z = 0; z <= bz; ++z, R += NB) {
        const int zp = z + z / bz;
        const float n0 = S[o0 + zp], n1 = S[o1 + zp];
        for (int sl = 0; sl < ns; ++sl) {
          const Pair q = ld_pair<VEC>(R, sl * sstride, ok1);
          acc[sl][0] += q.a * n0;
          acc[sl][1] += q.b * n1;
        }
      }
#pragma unroll
    for (int sl = 0; sl < WINDOW_R_SG; ++sl) {
      float* pp = part + ((sl * (bx + 1) + u) * vs + vi) * 2 * pairs + b0;
      pp[0] = acc[sl][0];
      pp[1] = acc[sl][1];
    }
  }
  __syncthreads();

  // each output sums its (u, vi) partials in that order
  for (int t = threadIdx.x; t < ns * g.BZ; t += blockDim.x) {
    const int sl = t / g.BZ, bb = t % g.BZ;
    float a = 0.f;
    for (int j = 0; j < (bx + 1) * vs; ++j)
      a += part[(sl * (bx + 1) * vs + j) * 2 * pairs + bb];
    yc[(long)(s0 + sl) * NB + p0 + bb] = a;
  }
}

// The (brick, local) pairs along one axis whose closed boxes hold node
// coordinate g: (g / b, g % b) when g < B b, then (g / b - 1, b) when g
// is a brick corner other than 0 -- in that order, n of them.
struct Axis {
  int b0, l0, b1, l1, n;
};
__device__ __forceinline__ Axis axis_pairs(int g, int b, int B) {
  Axis a{0, 0, 0, 0, 0};
  const int q = g / b, r = g - q * b;
  if (g < B * b) {
    a.b0 = q;
    a.l0 = r;
    a.n = 1;
  }
  if (r == 0 && g > 0) {
    if (a.n) {
      a.b1 = q - 1;
      a.l1 = b;
    } else {
      a.b0 = q - 1;
      a.l0 = b;
    }
    ++a.n;
  }
  return a;
}

// rng: the (2, box, NB) slot ranges [lo, hi) of ops/window.slot_ranges;
// the launcher checks that every Rst offset fits 32 bits.
template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    window_P_kernel(const V* __restrict__ Rst,
                    const uint8_t* __restrict__ rng, WinGeom g,
                    const float* __restrict__ xc, float* __restrict__ y) {
  const int NB = g.BX * g.BY * g.BZ;
  const int NYn = g.BY * g.by + 1, NZn = g.BZ * g.bz + 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (g.BX * g.bx + 1) * NYn * NZn) return;
  const int j = t % NZn;
  const int xy = t / NZn;
  const int gy = xy % NYn, gx = xy / NYn;
  // j enumerates z as (local z, brick z) with brick z fastest; the last
  // plane gz = BZ*bz comes last
  const int zlast = g.BZ * g.bz;
  const int gz = j < zlast ? (j % g.BZ) * g.bz + j / g.BZ : zlast;
  const Axis X = axis_pairs(gx, g.bx, g.BX), Y = axis_pairs(gy, g.by, g.BY),
             Z = axis_pairs(gz, g.bz, g.BZ);
  const int slot = (g.bx + 1) * (g.by + 1) * (g.bz + 1) * NB;  // box * NB
  float acc = 0.f;
  for (int ia = 0; ia < X.n; ++ia)
    for (int ib = 0; ib < Y.n; ++ib)
      for (int ic = 0; ic < Z.n; ++ic) {
        const int p = ((ia ? X.b1 : X.b0) * g.BY + (ib ? Y.b1 : Y.b0)) * g.BZ +
                      (ic ? Z.b1 : Z.b0);
        const int c = (((ia ? X.l1 : X.l0) * (g.by + 1) + (ib ? Y.l1 : Y.l0)) *
                           (g.bz + 1) +
                       (ic ? Z.l1 : Z.l0)) *
                          NB +
                      p;
        const int hi = rng[slot + c];
        for (int s = rng[c]; s < hi; ++s)
          acc += ld(Rst, s * slot + c) * xc[s * NB + p];
      }
  y[xy * NZn + gz] = acc;
}

static WinGeom make_geom(const int* geom) {
  WinGeom g;
  g.BX = geom[0];
  g.BY = geom[1];
  g.BZ = geom[2];
  g.bx = geom[3];
  g.by = geom[4];
  g.bz = geom[5];
  g.bs = geom[6];
  return g;
}

static dim3 blocks_for(long work) {
  return dim3((unsigned)((work + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
}

template <typename V, bool VEC, int ZE>
static cudaError_t launch_window_R(const V* Rst, const WinGeom& g,
                                   const int* plan, long smem,
                                   const float* r, float* yc,
                                   cudaStream_t s) {
  cudaError_t e = smem_limit((const void*)window_R_kernel<V, VEC, ZE>,
                             (size_t)smem);
  if (e != cudaSuccess) return e;
  window_R_kernel<V, VEC, ZE><<<dim3(plan[1], plan[2]), plan[0], smem, s>>>(
      Rst, g, plan[4], plan[5], r, yc);
  return cudaGetLastError();
}

template <typename V>
static cudaError_t window_R_typed(const V* Rst, const WinGeom& g,
                                  const int* plan, long smem, const float* r,
                                  float* yc, cudaStream_t s) {
  // 2-wide Rst loads need even brick offsets (BZ even makes every
  // z-line start and NB even) and a buffer aligned to two values
  const bool vec = g.BZ % 2 == 0 && (uintptr_t)Rst % (2 * sizeof(V)) == 0;
  if (g.bz == 8)
    return vec ? launch_window_R<V, true, 8>(Rst, g, plan, smem, r, yc, s)
               : launch_window_R<V, false, 8>(Rst, g, plan, smem, r, yc, s);
  return vec ? launch_window_R<V, true, 0>(Rst, g, plan, smem, r, yc, s)
             : launch_window_R<V, false, 0>(Rst, g, plan, smem, r, yc, s);
}

// plan: threads, grid x, grid y, shared bytes, vs, pitch
// (ops/window.window_R_plan).
extern "C" int saamge_window_R(int rst_bf16, const void* Rst,
                               const int* geom, const int* plan,
                               const float* r, float* yc, void* stream) {
  WinGeom g = make_geom(geom);
  const int threads = plan[0], vs = plan[4], pitch = plan[5];
  const long NB = (long)g.BX * g.BY * g.BZ,
             box = (long)(g.bx + 1) * (g.by + 1) * (g.bz + 1);
  // the 32-bit Rst offsets of the fast path: (SG - 1) slots and a row
  if (vs < 1 || vs > g.by + 1 || pitch < g.BZ * (g.bz + 1) + 1 ||
      threads < 32 || threads > WINDOW_R_THREADS || threads % 32 ||
      plan[1] != g.BX * g.BY ||
      plan[2] != (g.bs + WINDOW_R_SG - 1) / WINDOW_R_SG ||
      ((WINDOW_R_SG - 1) * box + g.bz + 1) * NB > 0x7fffffffL)
    return (int)cudaErrorInvalidConfiguration;
  const long smem = window_R_smem_floats(g, vs, pitch) * (long)sizeof(float);
  if (plan[3] != smem || smem > 232448)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      rst_bf16 ? window_R_typed((const __nv_bfloat16*)Rst, g, plan, smem, r,
                                yc, s)
               : window_R_typed((const float*)Rst, g, plan, smem, r, yc, s);
  return (int)e;
}

// rng: (2, box, NB) uint8 slot ranges (ops/window.slot_ranges).
extern "C" int saamge_window_P(int rst_bf16, const void* Rst,
                               const uint8_t* rng, const int* geom,
                               const float* xc, float* y, void* stream) {
  WinGeom g = make_geom(geom);
  long work = ((long)g.BX * g.bx + 1) * ((long)g.BY * g.by + 1) *
              ((long)g.BZ * g.bz + 1);
  const long box = (long)(g.bx + 1) * (g.by + 1) * (g.bz + 1);
  // the kernel's 32-bit offsets: Rst, the table and the nodes
  if (g.bs > 255 || (long)g.bs * box * g.BX * g.BY * g.BZ > 0x7fffffffL ||
      work > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rst_bf16)
    window_P_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)Rst, rng, g, xc, y);
  else
    window_P_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const float*)Rst, rng, g, xc, y);
  return (int)cudaGetLastError();
}
