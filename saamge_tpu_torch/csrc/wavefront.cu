// Kernel 2: one smoother sweep -- k chained stencil roots
//   x_r = x_{r-1} + dinv (b - A x_{r-1}) / tau_r,   r = 1..k
// and optionally the trailing residual b - A x_k, in ONE launch.
//
// Replaces: saamge_tpu/ops/pallas_wavefront.py `_build_sweep` (the
// skewed-wavefront Pallas sweep behind wavefront_smooth).
//
// Root r reads root r-1's values on rows that other blocks own, and
// Hopper blocks run in no order, so the levels are separated by a
// grid-wide barrier: the kernel is cooperative (all blocks resident,
// cooperative_groups::this_grid().sync() between levels) and walks the
// rows with a grid-stride loop.  Levels ping-pong between the output
// and a scratch buffer that the wrapper allocates, chosen so that the
// last root lands in the output.  The TPU kernel's VMEM budget model
// (plan_segments / _sweep_vmem_bytes) has no counterpart: one sweep
// takes all roots.
//
// Bound on this card: device-memory bytes.  Each level re-reads the
// diagonals (27 x 2 B a row for the bf16 twin; 49 MB at 912,673 rows,
// about the size of the 50 MB L2, so the re-reads partly hit L2).
// Streaming the diagonals once per sweep needs overlapped temporal tiles
// in shared memory; that is later work.
#include "common.cuh"

namespace cg = cooperative_groups;

template <typename V, bool RES>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    wavefront_kernel(const V* __restrict__ vals, Offsets offs, int n,
                     int halo, Taus taus, const float* __restrict__ b,
                     const float* __restrict__ dinv, const float* x0,
                     float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  const long total = (long)n + 2L * halo;
  const long stride = (long)gridDim.x * blockDim.x;
  const long t0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* src = x0;
  for (int r = 0; r < taus.k; ++r) {
    float* dst = ((taus.k - 1 - r) % 2 == 0) ? out : tmp;
    const float it = taus.inv_tau[r];
    for (long t = t0; t < total; t += stride) {
      long i = t - halo;
      if (i < 0 || i >= n) {
        dst[t] = 0.f;
        continue;
      }
      float ax = stencil_row(vals, offs, n, i, src, t);
      dst[t] = src[t] + dinv[t] * (b[t] - ax) * it;
    }
    grid.sync();
    src = dst;
  }
  if (RES) {
    for (long t = t0; t < total; t += stride) {
      long i = t - halo;
      if (i < 0 || i >= n) {
        res[t] = 0.f;
        continue;
      }
      res[t] = b[t] - stencil_row(vals, offs, n, i, src, t);
    }
  }
}

template <typename V>
static cudaError_t launch_wavefront(const V* vals, Offsets offs, int n,
                                    int halo, Taus taus, int emit_res,
                                    const float* b, const float* dinv,
                                    const float* x0, float* out, float* tmp,
                                    float* res, cudaStream_t stream) {
  void* args[] = {(void*)&vals, (void*)&offs, (void*)&n,    (void*)&halo,
                  (void*)&taus, (void*)&b,    (void*)&dinv, (void*)&x0,
                  (void*)&out,  (void*)&tmp,  (void*)&res};
  const void* func = emit_res ? (const void*)wavefront_kernel<V, true>
                              : (const void*)wavefront_kernel<V, false>;
  return launch_cooperative(func, (long)n + 2L * halo, args, stream);
}

extern "C" int saamge_wavefront(const void* vals, int vals_bf16,
                                const int* offsets, int k, int n, int halo,
                                const float* inv_taus, int n_roots,
                                int emit_res, const float* b,
                                const float* dinv, const float* x0,
                                float* out, float* tmp, float* res,
                                void* stream) {
  if (k < 1 || k > SAAMGE_MAX_DIAGS || n_roots < 1 ||
      n_roots > SAAMGE_MAX_ROOTS)
    return (int)cudaErrorInvalidValue;
  Offsets offs = make_offsets(offsets, k);
  Taus taus = make_taus(inv_taus, n_roots);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      vals_bf16 ? launch_wavefront((const __nv_bfloat16*)vals, offs, n,
                                   halo, taus, emit_res, b, dinv, x0, out,
                                   tmp, res, s)
                : launch_wavefront((const float*)vals, offs, n, halo, taus,
                                   emit_res, b, dinv, x0, out, tmp, res, s);
  return (int)e;
}
