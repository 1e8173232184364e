// Kernel 10: one pass of a block-row operator (ops/blockrow.py) over its
// packing, in four modes:
//   0 spmv       y[row0 + r] = sum_c V[r, c] x[col[c]]
//   1 residual   y = b - A x
//   2 root       y = x + (dinv * (b - A x)) / tau
//   3 transpose  y[col[c]] = sum_r V[r, c] x[row0 + r]   (A^T x)
// The root keeps the op order of the plain chain of solve/compiled.py
// smooth, x + (dinv * (b - A x)) / tau, with a true division.
//
// Replaces no TPU kernel: the JAX package leaves the block-row products to
// XLA (einsum / take, saamge_tpu/ops/blockrow.py).  In the port's plain
// torch each product was a chain of 50-180 small kernels (a concatenation,
// per bucket a gather and a batched product, a row gather; the transpose
// per bucket an index, a gather, a product and an index_add_), and the
// buckets pad rows to 8 and columns to 16, so they read 6-9x the values
// there are.  Here one launch does the whole product on the packing: a
// group's real rows and columns only, values row-major back to back,
// int32 columns, a descriptor (row0, nr, nc, value offset, column offset)
// a group, groups longest first.
//
// Design.  One warp a group.  Forward: lane l gathers x at the group's
// columns c = l, l + 32, ... once for all its rows and sums V[r, c] x[c]
// into one register a row, up to BLOCKROW_ROWS rows at a time (a group of
// more rows takes them in slices, gathering x again); then the warp's xor
// butterfly adds the 32 lane sums and lane r writes row r, with the mode's
// epilogue.  Transpose: lane l owns the columns c = l, l + 32, ... and
// sums its nr rows in turn; the column sets of the groups are disjoint
// (ops/blockrow.TransposedBlockRow checks it), so each output is written
// once, without atomics, and the columns no group covers are written 0 by
// warps past the last group.  Products and sums are rounded apart
// (__fmul_rn, __fadd_rn), in a fixed order: a run repeats bit for bit,
// and ops/blockrow.blockrow_plain, which walks the packing in this order,
// gives the same bits.
//
// Bound on this card: latency, not bytes.  The general path's largest
// product reads ~3.5 MB (level-1 operator at hexkway n=64: 544,790 values,
// 335,900 columns), ~1 us at 3.35 TB/s, and every operand of a V-cycle
// (~38 MB) stays in the 50 MB L2; a group is 1-4 rows of ~32 columns, so
// a warp's time is a chain of dependent loads (descriptor, columns, x)
// and a butterfly.  The column loop is unrolled so that the loads of
// several column slices are in flight at once.
#include "common.cuh"

#define BLOCKROW_ROWS 8   // rows a warp sums at once
#define BLOCKROW_WARPS 8  // warps per block

template <int MODE>
__global__ void __launch_bounds__(32 * BLOCKROW_WARPS)
    blockrow_kernel(const float* __restrict__ vals,
                    const int* __restrict__ cols,
                    const int* __restrict__ desc, int groups,
                    const int* __restrict__ uncovered, int n_uncovered,
                    const float* __restrict__ x, const float* __restrict__ b,
                    const float* __restrict__ dinv, float tau,
                    float* __restrict__ y) {
  const long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= groups) {
    if (MODE == 3) {
      const long t = (w - groups) * 32 + lane;
      if (t < n_uncovered) y[uncovered[t]] = 0.f;
    }
    return;
  }
  const int* d = desc + 5 * w;
  const int row0 = d[0], nr = d[1], nc = d[2];
  const float* V = vals + d[3];
  const int* C = cols + d[4];
  if (MODE == 3) {
#pragma unroll 4
    for (int c = lane; c < nc; c += 32) {
      float acc = 0.f;
      for (int r = 0; r < nr; ++r)
        acc = __fadd_rn(acc, __fmul_rn(V[(long)r * nc + c], x[row0 + r]));
      y[C[c]] = acc;
    }
    return;
  }
  for (int r0 = 0; r0 < nr; r0 += BLOCKROW_ROWS) {
    const int rn = min(BLOCKROW_ROWS, nr - r0);
    const float* Vr = V + (long)r0 * nc;
    float acc[BLOCKROW_ROWS];
#pragma unroll
    for (int r = 0; r < BLOCKROW_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int c = lane; c < nc; c += 32) {
      const float xv = x[C[c]];
#pragma unroll
      for (int r = 0; r < BLOCKROW_ROWS; ++r)
        if (r < rn)
          acc[r] = __fadd_rn(acc[r], __fmul_rn(Vr[(long)r * nc + c], xv));
    }
#pragma unroll
    for (int r = 0; r < BLOCKROW_ROWS; ++r) {
      if (r >= rn) break;  // warp-uniform
      float s = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == r) {
        const long i = (long)row0 + r0 + r;
        float out = s;
        if (MODE == 1) {
          out = __fsub_rn(b[i], s);
        } else if (MODE == 2) {
          out = __fadd_rn(x[i],
                          __fdiv_rn(__fmul_rn(dinv[i], __fsub_rn(b[i], s)),
                                    tau));
        }
        y[i] = out;
      }
    }
  }
}

template <int MODE>
static cudaError_t launch_blockrow(long grid, const float* vals,
                                   const int* cols, const int* desc,
                                   int groups, const int* uncovered,
                                   int n_uncovered, const float* x,
                                   const float* b, const float* dinv,
                                   float tau, float* y, cudaStream_t stream) {
  blockrow_kernel<MODE><<<(unsigned)grid, 32 * BLOCKROW_WARPS, 0, stream>>>(
      vals, cols, desc, groups, uncovered, n_uncovered, x, b, dinv, tau, y);
  return cudaGetLastError();
}

// mode: 0 spmv, 1 residual, 2 root, 3 transpose (MODES of
// ops/blockrow.py).  desc: (groups, 5) int32 rows (row0, nr, nc, value
// offset, column offset).  uncovered: the n_uncovered output columns the
// transpose writes 0 (not read by the other modes).  b and dinv may be
// null where the mode does not read them.
extern "C" int saamge_blockrow(int mode, const float* vals, const int* cols,
                               const int* desc, int groups,
                               const int* uncovered, int n_uncovered,
                               const float* x, const float* b,
                               const float* dinv, float tau, float* y,
                               void* stream) {
  if (mode < 0 || mode > 3 || groups < 0 || n_uncovered < 0 ||
      (mode == 1 && b == nullptr) ||
      (mode == 2 && (b == nullptr || dinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long warps =
      groups + (mode == 3 ? ((long)n_uncovered + 31) / 32 : 0L);
  if (warps == 0) return (int)cudaSuccess;
  const long grid = (warps + BLOCKROW_WARPS - 1) / BLOCKROW_WARPS;
  if (grid > 2147483647L) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return (int)launch_blockrow<0>(grid, vals, cols, desc, groups,
                                     uncovered, n_uncovered, x, b, dinv, tau,
                                     y, s);
    case 1:
      return (int)launch_blockrow<1>(grid, vals, cols, desc, groups,
                                     uncovered, n_uncovered, x, b, dinv, tau,
                                     y, s);
    case 2:
      return (int)launch_blockrow<2>(grid, vals, cols, desc, groups,
                                     uncovered, n_uncovered, x, b, dinv, tau,
                                     y, s);
    default:
      return (int)launch_blockrow<3>(grid, vals, cols, desc, groups,
                                     uncovered, n_uncovered, x, b, dinv, tau,
                                     y, s);
  }
}
