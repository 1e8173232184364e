// Kernel 12: y = A x for a symmetric n x n matrix stored as the T x T tiles
// of its lower triangle (ops/symv.pack_lower, T = SYMV_TILE): tile (I, J),
// J <= I, at index I (I + 1) / 2 + J, row-major inside, diagonal tiles
// whole, zero past n in the ragged last tile row and column.  The general
// path's coarsest correction applies the explicit inverse of its SPD
// coarsest operator with it (solve/compiled.py coarse_solve).
//
// Replaces no TPU kernel: the JAX package leaves the coarsest solve to two
// triangular solves with the Cholesky factor (jax.scipy.linalg.
// solve_triangular, saamge_tpu/solve/compiled.py coarse_solve).  On this
// card those were two cuBLAS trsv, a chain of dependent steps that read
// the 180 MB triangle at ~9 % of the memory rate (9,488 dofs: ~0.58 ms
// each).  The explicit inverse makes the solve one fully parallel product.
//
// Bound on this card: device-memory bytes.  At 9,488 dofs the product
// needs the n (n + 1) / 2 values of one triangle, 180.1 MB in f32, 53.7 us
// at 3.35 TB/s; the tiles store 2,850 x 64 KB = 186.8 MB (the diagonal
// tiles whole, the last tile row padded), and x, y and the workspace
// (nt^2 T values, 2.9 MB) stay in the L2.
//
// Design.  Stage 1, one block a tile: warp w of SYMV_WARPS holds the rows
// w, w + 8, ..., w + 120 and lane l the columns 4l .. 4l + 3, sixteen
// 16-byte loads a thread (each a warp's coalesced 512-byte row), all
// issued before any use.  From the same registers the block forms
// u = A_IJ x_J (a lane's four products summed in column order, then the
// warp's xor butterfly) and, off the diagonal, v = A_IJ^T x_I (a lane's
// sixteen rows summed in order, then the eight warps' sums in order
// through shared memory), so each stored value is read once for both
// products.  u goes to workspace slot (I, J) and v to slot (J, I), so
// every slot of the nt x nt is written once.  Stage 2, a second launch:
// y_I = the sum of the slots (I, J), warp w of a block adding J = w,
// w + 8, ... in order and then the eight warps in order, so that no
// output row is a chain of nt dependent loads (75 at 9,488 dofs).  No
// atomics, and products and sums rounded apart (mul_rn, add_rn: no fused
// multiply-add), so a call repeats bit for bit and ops/symv.symv_plain,
// which sums in this order, gives the same bits.
#include "common.cuh"

#define SYMV_TILE 128
#define SYMV_WARPS 8
#define SYMV_ROWS (SYMV_TILE / SYMV_WARPS)  // rows a warp holds

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Four consecutive values from a 16-byte-aligned address.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  o[0] = q0.x;
  o[1] = q0.y;
  o[2] = q1.x;
  o[3] = q1.y;
}

// Two f32 blocks an SM (at most 128 registers: a thread's 64 tile values
// and its sums), so that two tiles' loads are in flight on each SM; an
// f64 tile takes all of a block's registers.
template <typename T>
__global__ void __launch_bounds__(32 * SYMV_WARPS, sizeof(T) == 4 ? 2 : 1)
    symv_tile_kernel(const T* __restrict__ tiles, const T* __restrict__ x,
                     int n, int nt, T* __restrict__ work) {
  __shared__ T colsum[SYMV_WARPS][SYMV_TILE];
  const int t = blockIdx.x;
  // tile t = I (I + 1) / 2 + J, J <= I
  int I = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((long)I * (I + 1) / 2 > t) --I;
  while ((long)(I + 1) * (I + 2) / 2 <= t) ++I;
  const int J = t - I * (I + 1) / 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* tile = tiles + (long)t * SYMV_TILE * SYMV_TILE + 4 * lane;
  T a[SYMV_ROWS][4];
#pragma unroll
  for (int k = 0; k < SYMV_ROWS; ++k)
    load4(tile + (w + SYMV_WARPS * k) * SYMV_TILE, a[k]);

  // x_J at the lane's columns, x_I at the warp's rows; 0 past n
  T xj[4], xi[SYMV_ROWS];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = J * SYMV_TILE + 4 * lane + c;
    xj[c] = col < n ? x[col] : T(0);
  }
#pragma unroll
  for (int k = 0; k < SYMV_ROWS; ++k) {
    const int row = I * SYMV_TILE + w + SYMV_WARPS * k;
    xi[k] = row < n ? x[row] : T(0);
  }

  // u: row sums, a lane's columns in order, then the butterfly
  T u[SYMV_ROWS];
#pragma unroll
  for (int k = 0; k < SYMV_ROWS; ++k) {
    T s = mul_rn(a[k][0], xj[0]);
#pragma unroll
    for (int c = 1; c < 4; ++c) s = add_rn(s, mul_rn(a[k][c], xj[c]));
    u[k] = s;
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
#pragma unroll
    for (int k = 0; k < SYMV_ROWS; ++k)
      u[k] = add_rn(u[k], __shfl_xor_sync(0xffffffffu, u[k], m));
  T mine = u[0];
#pragma unroll
  for (int k = 1; k < SYMV_ROWS; ++k)
    if (lane == k) mine = u[k];
  if (lane < SYMV_ROWS)
    work[((long)I * nt + J) * SYMV_TILE + w + SYMV_WARPS * lane] = mine;

  if (I == J) return;  // the whole diagonal tile gave its product already
  // v: column sums, a lane's rows in order, then the warps in order
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T s = mul_rn(a[0][c], xi[0]);
#pragma unroll
    for (int k = 1; k < SYMV_ROWS; ++k) s = add_rn(s, mul_rn(a[k][c], xi[k]));
    colsum[w][4 * lane + c] = s;
  }
  __syncthreads();
  if (threadIdx.x < SYMV_TILE) {
    T s = colsum[0][threadIdx.x];
#pragma unroll
    for (int v = 1; v < SYMV_WARPS; ++v) s = add_rn(s, colsum[v][threadIdx.x]);
    work[((long)J * nt + I) * SYMV_TILE + threadIdx.x] = s;
  }
}

// Stage 2: a block sums the slots of 32 rows of one tile row (lane l
// row 32 b + l), warp w the tile columns J = w, w + 8, ... in order from
// zero, each load a warp's coalesced 128 bytes; then the eight warps'
// sums in order through shared memory.
template <typename T>
__global__ void __launch_bounds__(32 * SYMV_WARPS)
    symv_sum_kernel(const T* __restrict__ work, int n, int nt,
                    T* __restrict__ y) {
  __shared__ T part[SYMV_WARPS][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  const T* slots = work + (long)(i / SYMV_TILE) * nt * SYMV_TILE +
                   i % SYMV_TILE;
  T s = T(0);
#pragma unroll 4
  for (int J = w; J < nt; J += SYMV_WARPS)
    s = add_rn(s, slots[(long)J * SYMV_TILE]);
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    T t = part[0][lane];
#pragma unroll
    for (int v = 1; v < SYMV_WARPS; ++v) t = add_rn(t, part[v][lane]);
    y[i] = t;
  }
}

template <typename T>
static cudaError_t launch(const T* tiles, const T* x, int n, T* work, T* y,
                          cudaStream_t stream) {
  const int nt = (n + SYMV_TILE - 1) / SYMV_TILE;
  const long ntiles = (long)nt * (nt + 1) / 2;
  symv_tile_kernel<T><<<(unsigned)ntiles, 32 * SYMV_WARPS, 0, stream>>>(
      tiles, x, n, nt, work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  symv_sum_kernel<T><<<(n + 31) / 32, 32 * SYMV_WARPS, 0, stream>>>(
      work, n, nt, y);
  return cudaGetLastError();
}

// y = A x, A the lower tiles `tiles` of a symmetric n x n matrix; `work`
// holds nt^2 SYMV_TILE values, nt = ceil(n / SYMV_TILE).  f64: the tiles
// and vectors are double, else float.  `tiles` is 16-byte aligned.
extern "C" int saamge_symv(int f64, const void* tiles, const void* x, int n,
                           void* work, void* y, void* stream) {
  if (n < 1 || ((unsigned long)tiles & 15)) return (int)cudaErrorInvalidValue;
  const long nt = (n + SYMV_TILE - 1) / SYMV_TILE;
  if (nt * (nt + 1) / 2 > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return (int)launch((const double*)tiles, (const double*)x, n,
                       (double*)work, (double*)y, s);
  return (int)launch((const float*)tiles, (const float*)x, n, (float*)work,
                     (float*)y, s);
}
