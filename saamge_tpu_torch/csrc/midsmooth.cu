// Kernel 4: one mid-level smoothing chain on the brick-block operator --
// k chained roots  x_r = x_{r-1} + d (b - A1 x_{r-1}) / tau_r  and
// optionally the trailing residual b - A1 x_k, in ONE launch.
//
// Operator (slot-major padded layout, coarse dof (p, s) at s * NB + p):
//   blocks[k, s1, s2, p] = A1[(p, s1), (p + doff_k, s2)]
// over <= 27 brick offsets doff_k, with per-offset used-slot rectangles
// (r1_k, r2_k) beyond which a block is structurally zero.
//
// Replaces: saamge_tpu/ops/pallas_midsmooth.py `_build_mid_chain` (the
// VMEM-resident Pallas chain behind mid_chain); its plain building block
// is BrickBlockOp.matvec (saamge_tpu/solve/structured.py).
//
// Differences from the TPU kernel, on purpose:
//  * the neighbour brick p + doff is computed from (px, py, pz) with an
//    explicit bounds check; the TPU kernel's lane roll wraps and relies
//    on structurally zero blocks at wrapped lanes.
//  * full (not symmetry-halved) blocks are read; halving only saves
//    bytes and is later work.
//  * bf16 blocks are widened to f32 and multiplied in f32 (the TPU
//    kernel multiplies in bf16); x stays f32 across roots, and padded
//    slots stay zero because their d is 0.
//
// Bound on this card: the block bytes, re-read once per root (the full
// bf16 blocks are ~39 MB at the n=96 flagship and fit the 50 MB L2 --
// this card's analog of the TPU kernel's VMEM residency), plus one grid
// barrier per root.  Design: cooperative kernel as in wavefront.cu, one
// thread per output (s1, p) in a grid-stride loop, consecutive threads
// on consecutive bricks so block reads are coalesced.
#include "common.cuh"

namespace cg = cooperative_groups;

template <typename V>
__device__ __forceinline__ float mid_row(const V* __restrict__ blocks,
                                         const MidGeom& g, int NB, int s1,
                                         int p, const float* x) {
  const int pz = p % g.BZ, py = (p / g.BZ) % g.BY, px = p / (g.BY * g.BZ);
  float ax = 0.f;
  for (int k = 0; k < g.k; ++k) {
    if (s1 >= g.r1[k]) continue;
    const int q = mid_neighbour(g, k, px, py, pz);
    if (q < 0) continue;
    const V* B = blocks + ((long)k * g.bs + s1) * g.bs * NB + p;
    for (int s2 = 0; s2 < g.r2[k]; ++s2)
      ax += ld(B, (long)s2 * NB) * x[(long)s2 * NB + q];
  }
  return ax;
}

template <typename V, bool RES>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    mid_chain_kernel(const V* __restrict__ blocks, MidGeom g, Taus taus,
                     const float* __restrict__ b,
                     const float* __restrict__ d, const float* x0,
                     float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  const int NB = g.BX * g.BY * g.BZ;
  const long total = (long)g.bs * NB;
  const long stride = (long)gridDim.x * blockDim.x;
  const long t0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* src = x0;
  for (int r = 0; r < taus.k; ++r) {
    float* dst = ((taus.k - 1 - r) % 2 == 0) ? out : tmp;
    const float it = taus.inv_tau[r];
    for (long t = t0; t < total; t += stride) {
      const int s1 = (int)(t / NB), p = (int)(t % NB);
      float ax = mid_row(blocks, g, NB, s1, p, src);
      dst[t] = src[t] + d[t] * (b[t] - ax) * it;
    }
    grid.sync();
    src = dst;
  }
  if (RES) {
    for (long t = t0; t < total; t += stride) {
      const int s1 = (int)(t / NB), p = (int)(t % NB);
      res[t] = b[t] - mid_row(blocks, g, NB, s1, p, src);
    }
  }
}

template <typename V>
static cudaError_t launch_mid(const V* blocks, MidGeom g, Taus taus,
                              int emit_res, const float* b, const float* d,
                              const float* x0, float* out, float* tmp,
                              float* res, cudaStream_t stream) {
  void* args[] = {(void*)&blocks, (void*)&g,   (void*)&taus,
                  (void*)&b,      (void*)&d,   (void*)&x0,
                  (void*)&out,    (void*)&tmp, (void*)&res};
  const void* func = emit_res ? (const void*)mid_chain_kernel<V, true>
                              : (const void*)mid_chain_kernel<V, false>;
  return launch_cooperative(func, (long)g.bs * g.BX * g.BY * g.BZ, args,
                            stream);
}

// geom: BX, BY, BZ, bs, then per offset (dx, dy, dz, r1, r2).
extern "C" int saamge_mid_chain(const void* blocks, int blocks_bf16,
                                const int* geom, int n_offs,
                                const float* inv_taus, int n_roots,
                                int emit_res, const float* b, const float* d,
                                const float* x0, float* out, float* tmp,
                                float* res, void* stream) {
  if (n_offs < 1 || n_offs > SAAMGE_MAX_BOFFS || n_roots < 1 ||
      n_roots > SAAMGE_MAX_ROOTS)
    return (int)cudaErrorInvalidValue;
  MidGeom g = make_mid_geom(geom, n_offs);
  Taus taus = make_taus(inv_taus, n_roots);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      blocks_bf16 ? launch_mid((const __nv_bfloat16*)blocks, g, taus,
                               emit_res, b, d, x0, out, tmp, res, s)
                  : launch_mid((const float*)blocks, g, taus, emit_res, b,
                               d, x0, out, tmp, res, s);
  return (int)e;
}
