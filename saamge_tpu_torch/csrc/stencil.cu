// Kernel 1: the DIA stencil pass  y = A x,  y = b - A x,  or the smoother
// root  y = x + dinv (b - A x) / tau.
//
// Replaces: saamge_tpu/ops/pallas_stencil.py `_build` (the haloed
// (rows, 128) Pallas kernel behind PallasDIA.matvec_h / residual_h /
// root_h).
//
// Layout: flat vectors of length n + 2*halo with a zero halo of
// max|offset| rows on each side (no 128-lane tiling), so every tap
// x[i + off] is in bounds without a branch.  Values are row-aligned
// diagonals vals[k, i] = A[i, i + off_k], stored f32 (the PCG operator)
// or bf16 (the smoother twin); arithmetic is f32.
//
// Bound on this card: device-memory bytes.  Per row the pass reads k
// diagonal values (27 x 4 B or 2 B) and writes 4 B; the 27 x-taps of a
// row hit the same few cache lines as its neighbours' taps, so x costs
// about one read.  Design: one thread per row, adjacent threads on
// adjacent rows, so each diagonal read is one coalesced stream.  The
// halo rows are written as zeros, which keeps the output chainable.
#include <cstdint>

#include "common.cuh"

// MODE 0: spmv, 1: residual, 2: root.
template <typename V, int MODE>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    stencil_kernel(const V* __restrict__ vals, Offsets offs, int n,
                   int halo, const float* __restrict__ x,
                   const float* __restrict__ b,
                   const float* __restrict__ dinv, float inv_tau,
                   float* __restrict__ y) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long total = (long)n + 2L * halo;
  if (t >= total) return;
  long i = t - halo;
  if (i < 0 || i >= n) {
    y[t] = 0.f;
    return;
  }
  float ax = stencil_row(vals, offs, n, i, x, t);
  if (MODE == 0)
    y[t] = ax;
  else if (MODE == 1)
    y[t] = b[t] - ax;
  else
    y[t] = x[t] + dinv[t] * (b[t] - ax) * inv_tau;
}

template <typename V>
static cudaError_t launch_stencil(int mode, const V* vals, Offsets offs,
                                  int n, int halo, const float* x,
                                  const float* b, const float* dinv,
                                  float inv_tau, float* y,
                                  cudaStream_t stream) {
  long total = (long)n + 2L * halo;
  dim3 grid((unsigned)((total + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
  dim3 block(SAAMGE_THREADS);
  if (mode == 0)
    stencil_kernel<V, 0><<<grid, block, 0, stream>>>(vals, offs, n, halo, x,
                                                     b, dinv, inv_tau, y);
  else if (mode == 1)
    stencil_kernel<V, 1><<<grid, block, 0, stream>>>(vals, offs, n, halo, x,
                                                     b, dinv, inv_tau, y);
  else if (mode == 2)
    stencil_kernel<V, 2><<<grid, block, 0, stream>>>(vals, offs, n, halo, x,
                                                     b, dinv, inv_tau, y);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int saamge_stencil(int mode, const void* vals, int vals_bf16,
                              const int* offsets, int k, int n, int halo,
                              const float* x, const float* b,
                              const float* dinv, float inv_tau, float* y,
                              void* stream) {
  if (k < 1 || k > SAAMGE_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  Offsets offs = make_offsets(offsets, k);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      vals_bf16
          ? launch_stencil(mode, (const __nv_bfloat16*)vals, offs, n, halo,
                           x, b, dinv, inv_tau, y, s)
          : launch_stencil(mode, (const float*)vals, offs, n, halo, x, b,
                           dinv, inv_tau, y, s);
  return (int)e;
}

extern "C" const char* saamge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
