// Kernel 11: the node-block stencil of a vector field (ops/sparse.NodeBlock,
// 3D linear elasticity's finest level): 27 node offsets of dense 3 x 3
// blocks, vals[k, a, b, p] = A[3 p + a, 3 (p + off[k]) + b], stored
// (27 x 3 x 3, N) so that the threads of a warp, one node each, read each
// block entry of 32 consecutive nodes in one coalesced load.  Three modes:
//   0 spmv      y = A x
//   1 residual  y = b - A x
//   2 chain     k chained roots x_r = x_{r-1} + dinv (b - A x_{r-1}) / tau_r
//               and optionally the trailing residual b - A x_k, in ONE
//               cooperative launch
// over haloed vectors (halo nodes of zeros on each side, so every
// neighbour load is in bounds; the output's halo is written 0).
//
// Replaces no TPU kernel: the JAX package stores this operator as ELL and
// leaves its product to XLA.  In the port's plain torch each ELL product
// wrote and re-read two n x 81 temporaries and read int64 columns, ~7x the
// f32 values.  The node-block format stores the values only: the column
// of a value is its node's offset, in the parameter bank.
//
// Design.  One thread a node: it loads its 27 neighbours' 3-vectors once
// and serves the node's three rows from them (243 values, 81 a row).  The
// chain runs one level (a root, or the residual) at a time, a grid
// barrier between levels, and walks every second level backward, so that
// it starts on the nodes the level before it wrote last, whose values are
// still in L2 (the operator, 67 MB at n=40, does not fit the 50 MB L2:
// each level streams the rest from device memory).  Levels ping-pong
// between `out` and `tmp` (common.cuh level_buf).  Products and sums are
// rounded apart (__fmul_rn, __fadd_rn), a row's sum running over the
// offsets in order and, in each, over the block's columns in order, so a
// run repeats bit for bit and ops/vstencil.vstencil_plain, which sums in
// this order, gives the same bits.  Indices are 32-bit (the launcher
// checks that the values and the haloed vectors fit).
//
// Bound on this card: device-memory bytes, the values once a level.
#include "common.cuh"

namespace cg = cooperative_groups;

#define VS_MIN_BLOCKS 3  // resident blocks per SM (at most 80 registers)

// Node t (haloed index) of one level: MODE 0 spmv, 1 residual, 2 root.
// Halo nodes get 0.
template <int K, int MODE>
__device__ __forceinline__ void node_level(
    const float* __restrict__ vals, const Offsets& offs, int nodes,
    int halo, int t, float it, const float* __restrict__ b,
    const float* __restrict__ dinv, const float* src, float* dst) {
  float* y = dst + 3 * t;
  if (t < halo || t >= nodes + halo) {
    y[0] = 0.f;
    y[1] = 0.f;
    y[2] = 0.f;
    return;
  }
  const int i = t - halo;
  float bs[3], xs[3], ds[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bs[a] = MODE > 0 ? b[3 * t + a] : 0.f;
    xs[a] = MODE == 2 ? src[3 * t + a] : 0.f;
    ds[a] = MODE == 2 ? dinv[3 * t + a] : 0.f;
  }
  float acc[3] = {0.f, 0.f, 0.f};
  const int kc = K > 0 ? K : offs.k;
#pragma unroll
  for (int k = 0; k < kc; ++k) {
    const float* xk = src + 3 * (t + offs.off[k]);
    const float xv[3] = {xk[0], xk[1], xk[2]};
    const float* v = vals + 9 * k * nodes + i;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[a] = __fadd_rn(acc[a], __fmul_rn(v[(3 * a + c) * nodes], xv[c]));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (MODE == 0)
      y[a] = acc[a];
    else if (MODE == 1)
      y[a] = __fsub_rn(bs[a], acc[a]);
    else
      y[a] = __fadd_rn(xs[a],
                       __fmul_rn(__fmul_rn(ds[a], __fsub_rn(bs[a], acc[a])),
                                 it));
  }
}

template <int K, int MODE>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    vstencil_pass_kernel(const float* __restrict__ vals, Offsets offs,
                         int nodes, int halo, const float* __restrict__ b,
                         const float* x, float* y) {
  const int t = blockIdx.x * SAAMGE_THREADS + threadIdx.x;
  if (t < nodes + 2 * halo)
    node_level<K, MODE>(vals, offs, nodes, halo, t, 0.f, b, nullptr, x, y);
}

template <int K, bool RES>
__global__ void __launch_bounds__(SAAMGE_THREADS, VS_MIN_BLOCKS)
    vstencil_chain_kernel(const float* __restrict__ vals, Offsets offs,
                          int nodes, int halo, Taus taus,
                          const float* __restrict__ b,
                          const float* __restrict__ dinv, const float* x0,
                          float* out, float* tmp, float* res) {
  cg::grid_group grid = cg::this_grid();
  const int total = nodes + 2 * halo;
  const int L = taus.k + (RES ? 1 : 0);
  const int chunks = (total + SAAMGE_THREADS - 1) / SAAMGE_THREADS;
  const float* src = x0;
  for (int r = 1; r <= L; ++r) {
    float* dst = r <= taus.k ? level_buf(r, taus.k, out, tmp) : res;
    for (int c0 = blockIdx.x; c0 < chunks; c0 += gridDim.x) {
      const int c = (r & 1) ? c0 : chunks - 1 - c0;
      const int t = c * SAAMGE_THREADS + threadIdx.x;
      if (t >= total) continue;
      if (r > taus.k)
        node_level<K, 1>(vals, offs, nodes, halo, t, 0.f, b, dinv, src,
                         dst);
      else
        node_level<K, 2>(vals, offs, nodes, halo, t, taus.inv_tau[r - 1], b,
                         dinv, src, dst);
    }
    if (r < L) grid.sync();
    src = dst;
  }
}

template <int K>
static cudaError_t launch_pass(int mode, const float* vals, Offsets offs,
                               int nodes, int halo, const float* b,
                               const float* x, float* y,
                               cudaStream_t stream) {
  const long total = (long)nodes + 2L * halo;
  dim3 grid((unsigned)((total + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
  dim3 block(SAAMGE_THREADS);
  if (mode == 0)
    vstencil_pass_kernel<K, 0><<<grid, block, 0, stream>>>(
        vals, offs, nodes, halo, b, x, y);
  else
    vstencil_pass_kernel<K, 1><<<grid, block, 0, stream>>>(
        vals, offs, nodes, halo, b, x, y);
  return cudaGetLastError();
}

template <int K>
static cudaError_t launch_chain(const float* vals, Offsets offs, int nodes,
                                int halo, Taus taus, int emit_res,
                                const float* b, const float* dinv,
                                const float* x0, float* out, float* tmp,
                                float* res, cudaStream_t stream) {
  void* args[] = {(void*)&vals, (void*)&offs, (void*)&nodes, (void*)&halo,
                  (void*)&taus, (void*)&b,    (void*)&dinv,  (void*)&x0,
                  (void*)&out,  (void*)&tmp,  (void*)&res};
  const void* func = emit_res
                         ? (const void*)vstencil_chain_kernel<K, true>
                         : (const void*)vstencil_chain_kernel<K, false>;
  return launch_cooperative(func, (long)nodes + 2L * halo, args, stream);
}

// mode 0 spmv / 1 residual: out = (b -) A x.  mode 2 chain: n_roots roots
// from x into out (tmp: the other ping-pong buffer), and with emit_res the
// residual into res.  Vectors are haloed f32 of 3 (nodes + 2 halo).
extern "C" int saamge_vstencil(int mode, const float* vals,
                               const int* offsets, int k, int nodes,
                               int halo, const float* inv_taus, int n_roots,
                               int emit_res, const float* b,
                               const float* dinv, const float* x, float* out,
                               float* tmp, float* res, void* stream) {
  if (mode < 0 || mode > 2 || k < 1 || k > SAAMGE_MAX_BOFFS || nodes < 1 ||
      halo < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == 2 && (n_roots < 1 || n_roots > SAAMGE_MAX_ROOTS))
    return (int)cudaErrorInvalidValue;
  // 32-bit value and vector indices: 9 k nodes values, and 3 entries a
  // haloed node rounded up to whole chunks
  const long total = (long)nodes + 2L * halo;
  if (9L * k * nodes > 0x7fffffffL ||
      3L * (total + SAAMGE_THREADS) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  Offsets offs = make_offsets(offsets, k);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (mode < 2) {
    e = k == 27 ? launch_pass<27>(mode, vals, offs, nodes, halo, b, x, out, s)
                : launch_pass<0>(mode, vals, offs, nodes, halo, b, x, out, s);
  } else {
    Taus taus = make_taus(inv_taus, n_roots);
    e = k == 27 ? launch_chain<27>(vals, offs, nodes, halo, taus, emit_res,
                                   b, dinv, x, out, tmp, res, s)
                : launch_chain<0>(vals, offs, nodes, halo, taus, emit_res, b,
                                  dinv, x, out, tmp, res, s);
  }
  return (int)e;
}
