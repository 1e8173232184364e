// Kernel 2: one smoother sweep -- k chained stencil roots
//   x_r = x_{r-1} + dinv (b - A x_{r-1}) / tau_r,   r = 1..k
// and optionally the trailing residual b - A x_k (level k + 1), in ONE
// launch.
//
// Replaces: saamge_tpu/ops/pallas_wavefront.py `_build_sweep` (the
// skewed-wavefront Pallas sweep behind wavefront_smooth), and, with f32
// values, saamge_tpu/ops/pallas_smoother.py `_build` (ops/smoother.py).
//
// Bound on this card: device-memory bytes, the diagonals (27 x 2 B a row
// for the bf16 twin, 49 MB at 912,673 rows) read once per sweep.  The
// first version put a grid barrier between levels and re-read all the
// diagonals every level, at ~40 % of the bandwidth: a runtime tap
// count, 64-bit index arithmetic per tap, and b, dinv and x[t] loaded
// only after the tap sum (a second memory round trip per row).
//
// Schedule: one level at a time, a grid barrier (the launch is
// cooperative) between levels, since level r reads level r-1 on rows
// that other blocks computed.  Levels ping-pong between `out` and `tmp`,
// chosen so that the last root lands in `out`; the residual goes to
// `res`.  Every second level walks its chunks backward, so that it starts
// on the rows the level before it wrote last, which are still in L2.
// Levels lagged by two slabs of 1-3 halos, with a barrier a step, keep
// the diagonals of the slabs in flight in L2 but ran slower on the H100
// (PERF.md section 6): each of their 2 (L - 1) + slabs steps costs a
// barrier and a memory round trip.
//
// Level body: a block takes chunks of SAAMGE_THREADS rows of the level,
// a thread one row, and issues all its loads -- the taps' values
// and x, and the row's own x, b and dinv -- before it sums.  Three blocks
// an SM (80 registers) ran as fast as four in bf16 and faster in f32,
// where 64 registers spill; two rows a thread ran slower.  The tap count
// is a template parameter (27, the flagship twin and the general
// smoother; 0 = runtime count for other operators, chosen by shape),
// offsets sit in the parameter bank and row indices are 32-bit (the
// launcher checks that k n and the rows fit).  Taps are summed in offset
// order with the expression of csrc/stencil.cu, so each row equals the
// stencil kernel's root pass bit for bit.
#include "common.cuh"

namespace cg = cooperative_groups;

#define WAVE_MIN_BLOCKS 3  // resident blocks per SM (80 registers, no spills)

// Row t (< t_end) of one level: a root (res == nullptr) or the residual
// into res.  Halo rows get 0.
template <typename V, int K>
__device__ __forceinline__ void level_row(
    const V* __restrict__ vals, const Offsets& offs, int n, int halo, int t,
    int t_end, float it, const float* __restrict__ b,
    const float* __restrict__ dinv, const float* src, float* dst,
    float* res) {
  if (t >= t_end) return;
  const bool ok = t >= halo && t < n + halo;
  const int i = t - halo;
  // the row's own x, b and dinv are loaded with the taps, so that a row
  // costs one memory round trip
  const float xs = ok && res == nullptr ? src[t] : 0.f;
  const float ds = ok && res == nullptr ? dinv[t] : 0.f;
  const float bs = ok ? b[t] : 0.f;
  float ax = 0.f;
  if constexpr (K > 0) {
    float wv[K], xv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wv[k] = ok ? ld(vals, k * n + i) : 0.f;
      xv[k] = ok ? src[t + offs.off[k]] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ax += wv[k] * xv[k];
  } else if (ok) {
    for (int k = 0; k < offs.k; ++k)
      ax += ld(vals, k * n + i) * src[t + offs.off[k]];
  }
  if (res != nullptr)
    res[t] = ok ? bs - ax : 0.f;
  else
    dst[t] = ok ? xs + ds * (bs - ax) * it : 0.f;
}

template <typename V, int K, bool RES>
__global__ void __launch_bounds__(SAAMGE_THREADS, WAVE_MIN_BLOCKS)
    wavefront_kernel(const V* __restrict__ vals, Offsets offs, int n,
                     int halo, Taus taus, const float* __restrict__ b,
                     const float* __restrict__ dinv, const float* x0,
                     float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  const int total = n + 2 * halo;
  const int L = taus.k + (RES ? 1 : 0);
  const int chunks = (total + SAAMGE_THREADS - 1) / SAAMGE_THREADS;
  const float* src = x0;
  for (int r = 1; r <= L; ++r) {
    float* dst = r <= taus.k ? level_buf(r, taus.k, out, tmp) : nullptr;
    for (int c0 = blockIdx.x; c0 < chunks; c0 += gridDim.x) {
      const int c = (r & 1) ? c0 : chunks - 1 - c0;
      const int t = c * SAAMGE_THREADS + threadIdx.x;
      if (r > taus.k)
        level_row<V, K>(vals, offs, n, halo, t, total, 0.f, b, dinv, src,
                        nullptr, res);
      else
        level_row<V, K>(vals, offs, n, halo, t, total, taus.inv_tau[r - 1],
                        b, dinv, src, dst, nullptr);
    }
    if (r < L) grid.sync();
    src = dst;
  }
}

template <typename V, int K>
static cudaError_t launch_wavefront(const V* vals, Offsets offs, int n,
                                    int halo, Taus taus, int emit_res,
                                    const float* b, const float* dinv,
                                    const float* x0, float* out, float* tmp,
                                    float* res, cudaStream_t stream) {
  void* args[] = {(void*)&vals, (void*)&offs, (void*)&n,    (void*)&halo,
                  (void*)&taus, (void*)&b,    (void*)&dinv, (void*)&x0,
                  (void*)&out,  (void*)&tmp,  (void*)&res};
  const void* func = emit_res ? (const void*)wavefront_kernel<V, K, true>
                              : (const void*)wavefront_kernel<V, K, false>;
  return launch_cooperative(func, (long)n + 2L * halo, args, stream);
}

template <typename V>
static cudaError_t wavefront_typed(const V* vals, Offsets offs, int n,
                                   int halo, Taus taus, int emit_res,
                                   const float* b, const float* dinv,
                                   const float* x0, float* out, float* tmp,
                                   float* res, cudaStream_t s) {
  if (offs.k == 27)
    return launch_wavefront<V, 27>(vals, offs, n, halo, taus, emit_res, b,
                                   dinv, x0, out, tmp, res, s);
  return launch_wavefront<V, 0>(vals, offs, n, halo, taus, emit_res, b,
                                dinv, x0, out, tmp, res, s);
}

extern "C" int saamge_wavefront(const void* vals, int vals_bf16,
                                const int* offsets, int k, int n, int halo,
                                const float* inv_taus, int n_roots,
                                int emit_res, const float* b,
                                const float* dinv, const float* x0,
                                float* out, float* tmp, float* res,
                                void* stream) {
  if (k < 1 || k > SAAMGE_MAX_DIAGS || n_roots < 1 ||
      n_roots > SAAMGE_MAX_ROOTS || n < 1 || halo < 1)
    return (int)cudaErrorInvalidValue;
  // 32-bit row and value indices: k n values, and the rows rounded up to
  // whole chunks
  const long total = (long)n + 2L * halo;
  if ((long)k * n > 0x7fffffffL || total + SAAMGE_THREADS > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  Offsets offs = make_offsets(offsets, k);
  Taus taus = make_taus(inv_taus, n_roots);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      vals_bf16
          ? wavefront_typed((const __nv_bfloat16*)vals, offs, n, halo, taus,
                            emit_res, b, dinv, x0, out, tmp, res, s)
          : wavefront_typed((const float*)vals, offs, n, halo, taus,
                            emit_res, b, dinv, x0, out, tmp, res, s);
  return (int)e;
}
