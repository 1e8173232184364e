// Kernel 6: one brick-block matvec  y = A1 x  of the mid level, over the
// packed per-offset used-slot rectangles (the operator stored without its
// structurally zero slot pairs).
//
// Operator (slot-major padded layout, coarse dof (p, s) at s * NB + p):
//   packed[start_k + (s1 * r2_k + s2) * NB + p] = A1[(p, s1), (p + doff_k, s2)]
// for s1 < r1_k, s2 < r2_k; start_k = sum_{j<k} r1_j r2_j NB.  Output
// slots s1 outside every rectangle (the padding slots) get 0.
//
// Replaces: saamge_tpu/ops/pallas_midmv.py `_build_chunked_mv` (the
// lane-chunked streamed Pallas matvec behind chunked_matvec).
//
// Differences from the TPU kernel, on purpose:
//  * its lane chunking (chunk_plan, Lc, nside, the 16-row sublane padding)
//    is a VMEM budget and is not ported: each thread reads what it needs.
//  * the neighbour brick p + doff is computed from (px, py, pz) with an
//    explicit bounds check (as in midsmooth.cu); the TPU kernel shifts
//    lanes across x-slabs and relies on structurally zero block entries
//    at the wrapped lanes.
//  * bf16 blocks are widened to f32 and multiplied by the f32 x in f32
//    (the TPU kernel rounds x and each product to bf16).
//
// Bound on this card: the packed block bytes, read once per pass (x is
// bs * NB * 4 B and stays in cache).  Design: one thread per output
// (s1, p), consecutive threads on consecutive bricks, so each block row
// s2 is one coalesced read across the warp.
#include "common.cuh"

struct PackedStarts {
  long start[SAAMGE_MAX_BOFFS];
};

template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    midmv_kernel(const V* __restrict__ packed, MidGeom g, PackedStarts st,
                 const float* __restrict__ x, float* __restrict__ y) {
  const int NB = g.BX * g.BY * g.BZ;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)g.bs * NB) return;
  const int s1 = (int)(t / NB), p = (int)(t % NB);
  const int pz = p % g.BZ, py = (p / g.BZ) % g.BY, px = p / (g.BY * g.BZ);
  float ax = 0.f;
  for (int k = 0; k < g.k; ++k) {
    if (s1 >= g.r1[k]) continue;
    const int q = mid_neighbour(g, k, px, py, pz);
    if (q < 0) continue;
    const V* B = packed + st.start[k] + (long)s1 * g.r2[k] * NB + p;
    for (int s2 = 0; s2 < g.r2[k]; ++s2)
      ax += ld(B, (long)s2 * NB) * x[(long)s2 * NB + q];
  }
  y[t] = ax;
}

template <typename V>
static cudaError_t launch_midmv(const V* packed, const MidGeom& g,
                                const PackedStarts& st, const float* x,
                                float* y, cudaStream_t stream) {
  const long total = (long)g.bs * g.BX * g.BY * g.BZ;
  dim3 grid((unsigned)((total + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
  midmv_kernel<V><<<grid, dim3(SAAMGE_THREADS), 0, stream>>>(packed, g, st,
                                                             x, y);
  return cudaGetLastError();
}

// geom as saamge_mid_chain's: BX, BY, BZ, bs, then per offset
// (dx, dy, dz, r1, r2).
extern "C" int saamge_midmv(const void* packed, int packed_bf16,
                            const int* geom, int n_offs, const float* x,
                            float* y, void* stream) {
  if (n_offs < 1 || n_offs > SAAMGE_MAX_BOFFS)
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
          ? launch_midmv((const __nv_bfloat16*)packed, g, st, x, y, s)
          : launch_midmv((const float*)packed, g, st, x, y, s);
  return (int)e;
}
