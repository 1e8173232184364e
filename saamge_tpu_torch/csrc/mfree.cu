// Kernel 5: the matrix-free Q1 fine operator  y = A x,  y = b - A x,  or the
// smoother root  y = x + dinv (b - A x) / tau,  with the 27 stencil values
// of each row recomputed from the element coefficient field c and the 8x8
// reference element matrix K:
//
//   A[u, u + delta] = sum_{corner(l') - corner(l) = delta} K[l, l'] c(u - corner(l))
//   A x = m * A_full(m * x) + (1 - m) * d * x      (m: free-dof node mask)
//
// Replaces: saamge_tpu/ops/pallas_mfree.py `_build_mfree` (the Pallas
// kernel behind MatrixFreeQ1.matvec_h / residual_h / root_h).
//
// Layout: the flat haloed vectors of stencil.cu (halo = sx + sy + 1 zeros
// on each side, sx = NYn*NZn, sy = NZn).  c is zero on the last node plane
// of each dimension and in the halo, so a tap that wraps to the next grid
// line or leaves the grid meets a zero coefficient and needs no branch.
// c and m are f32 (the PCG operator) or bf16 (the smoother twin), widened
// on load; arithmetic is f32.
//
// Bound on this card: per node the pass reads c, m, x (and b, dinv) and
// writes y -- about 20 B/node with bf16 c and m, against ~60 B/node for
// the stored-bf16 stencil -- plus ~91 FMAs (64 to rebuild the 27 values,
// 27 for the product).  Design: one thread per node, adjacent threads on
// adjacent nodes, so every tap load is a coalesced stream that the
// neighbouring rows' taps reuse from cache.  The 27 values live in
// registers: the corner loops are fully unrolled, so every value's slot
// is a compile-time index.  The halo rows are written as zeros, which
// keeps the output chainable.
#include "common.cuh"

struct ElemMatrix {
  float k[64];  // K[l, l'] row-major, MFEM hex corner order
};

// MFEM hex corner l: (0,0,0) (1,0,0) (1,1,0) (0,1,0), then the same at z=1.
__device__ __forceinline__ int corner_x(int l) {
  return ((l & 3) == 1 || (l & 3) == 2) ? 1 : 0;
}
__device__ __forceinline__ int corner_y(int l) { return (l & 3) >= 2 ? 1 : 0; }
__device__ __forceinline__ int corner_z(int l) { return l >= 4 ? 1 : 0; }

// MODE 0: spmv, 1: residual, 2: root.
template <typename V, int MODE>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    mfree_kernel(const V* __restrict__ c, const V* __restrict__ m,
                 ElemMatrix K, long sx, long sy, long n, long halo,
                 const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ dinv, float inv_tau,
                 float* __restrict__ y) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n + 2 * halo) return;
  const long i = t - halo;
  if (i < 0 || i >= n) {
    y[t] = 0.f;
    return;
  }
  float cl[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    cl[l] = ld(c, t - (corner_x(l) * sx + corner_y(l) * sy + corner_z(l)));
  // val[(dx+1)*9 + (dy+1)*3 + (dz+1)] = A[u, u + dx*sx + dy*sy + dz]
  float val[27];
#pragma unroll
  for (int q = 0; q < 27; ++q) val[q] = 0.f;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int lp = 0; lp < 8; ++lp) {
      const int q = (corner_x(lp) - corner_x(l) + 1) * 9 +
                    (corner_y(lp) - corner_y(l) + 1) * 3 +
                    (corner_z(lp) - corner_z(l) + 1);
      val[q] += K.k[l * 8 + lp] * cl[l];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < 27; ++q) {
    const long off = (q / 9 - 1) * sx + ((q / 3) % 3 - 1) * sy + (q % 3 - 1);
    acc += val[q] * (x[t + off] * ld(m, t + off));
  }
  const float mc = ld(m, t), xc = x[t];
  const float ax = mc * acc + (1.f - mc) * (val[13] * xc);
  if (MODE == 0)
    y[t] = ax;
  else if (MODE == 1)
    y[t] = b[t] - ax;
  else
    y[t] = xc + dinv[t] * (b[t] - ax) * inv_tau;
}

template <typename V>
static cudaError_t launch_mfree(int mode, const V* c, const V* m,
                                const ElemMatrix& K, long sx, long sy,
                                long n, long halo, const float* x,
                                const float* b, const float* dinv,
                                float inv_tau, float* y,
                                cudaStream_t stream) {
  const long total = n + 2 * halo;
  dim3 grid((unsigned)((total + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
  dim3 block(SAAMGE_THREADS);
  if (mode == 0)
    mfree_kernel<V, 0><<<grid, block, 0, stream>>>(c, m, K, sx, sy, n, halo,
                                                   x, b, dinv, inv_tau, y);
  else if (mode == 1)
    mfree_kernel<V, 1><<<grid, block, 0, stream>>>(c, m, K, sx, sy, n, halo,
                                                   x, b, dinv, inv_tau, y);
  else if (mode == 2)
    mfree_kernel<V, 2><<<grid, block, 0, stream>>>(c, m, K, sx, sy, n, halo,
                                                   x, b, dinv, inv_tau, y);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int saamge_mfree(int mode, const void* c, const void* m,
                            int cm_bf16, const float* K, int NXn, int NYn,
                            int NZn, int halo, const float* x, const float* b,
                            const float* dinv, float inv_tau, float* y,
                            void* stream) {
  const long sx = (long)NYn * NZn, sy = NZn;
  if (NXn < 2 || NYn < 2 || NZn < 2 || halo < sx + sy + 1)
    return (int)cudaErrorInvalidValue;
  ElemMatrix Km;
  for (int i = 0; i < 64; ++i) Km.k[i] = K[i];
  const long n = (long)NXn * sx;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cm_bf16 ? launch_mfree(mode, (const __nv_bfloat16*)c,
                             (const __nv_bfloat16*)m, Km, sx, sy, n,
                             (long)halo, x, b, dinv, inv_tau, y, s)
              : launch_mfree(mode, (const float*)c, (const float*)m, Km, sx,
                             sy, n, (long)halo, x, b, dinv, inv_tau, y, s);
  return (int)e;
}
