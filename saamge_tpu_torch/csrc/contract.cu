// Kernel 8: the exact-f32 tent contractions over extracted boxes
//
//   R:  y[c, n] = sum_b Rst[c, b, n] * boxes[b, n]     (bs, NB)
//   P:  C[b, n] = sum_c Rst[c, b, n] * xc[c, n]        (box, NB)
//
// with Rst the slot-major (bs, box, NB) tent blocks (f32 or bf16, widened
// to f32), boxes the (box, NB) closed-brick windows of the fine residual,
// xc the (bs, NB) coarse values; every sum is f32.
//
// Replaces: saamge_tpu/ops/pallas_contract.py `_build_contract` (modes R
// and P).  The TPU kernel walks brick chunks of 128 lanes with the whole
// (bs, box, 128) slab in VMEM and pads Rst to (8, 128) tiles (`pad_rst`);
// neither the chunking nor the padding has a counterpart here.
//
// Bound on this card: device-memory bytes.  Of the dense Rst (25.2 M
// values at the n=96 flagship) only 3.9 % are structurally nonzero: a
// box node lies in one MIS, whose coarse dofs hold consecutive slots of
// its master brick, so the nonzeros of each column Rst[:, b, n] are one
// slot range [lo, hi), empty for the nodes of MISes that other bricks
// master.  What any R or P must move is those values and the two vectors
// (9.2 MB at n=96, 2.7 us at 3.35 TB/s).  The first kernels read the
// dense Rst (R one thread per (c, n) walking all box nodes in one
// dependent chain: 0.0863 ms at n=96; P 0.0318 ms); these read only the
// nonzeros, each from a table built once at compile.  All offsets are
// 32-bit (the launchers check they fit).
//
// R: by-slot node lists (ops/contract.slot_lists): for each output
// o = (c, n) the ascending box nodes b of its nonzeros and their values
// in f32, the outputs ranked by list length, longest first, and their
// lists back to back, so that a warp's loads are consecutive.  The
// per-output work is very uneven (343 terms for an interior-MIS slot of an
// 8^3 brick, 49, 7 or 1 for the others, none for a padding slot), so a
// warp takes one task of one length class: one list of more than 8 terms
// (32 lanes striding it), four of 2 to 8 terms (8 lanes each) or 32 of 0
// or 1 term (a lane each); the lanes of an output sum in a fixed butterfly,
// so repeats are bit-equal.  A task's outputs follow from its index and the
// two class boundaries (ops/contract.contract_R_plan), with no table load.
// The first design measured against it walked the box nodes in clusters
// of 8 blocks, partial sums in shared memory reduced through distributed
// shared memory: 0.0117 ms against 0.0082-0.0084 at n=96 (PERF.md).
//
// P: one thread per (b, n), consecutive threads on consecutive bricks n
// (the table, Rst and xc loads of a warp coalesce), summing in ascending
// c only the slots of its range in `rng` (ops/window.slot_ranges, a
// (2, box, NB) uint8 table).  A skipped term is an exact zero, so a launch
// with the true ranges equals one with full ranges [0, bs) bit for bit.
#include <stdint.h>

#include "common.cuh"

// Task t's ranks [k0, k1) and lanes per output g: ranks [0, nlong) one a
// task (g = 32), [nlong, nshort) four a task (g = 8), the rest 32 a task
// (g = 1).
__device__ __forceinline__ void R_task(int t, int nlong, int nshort,
                                       int outputs, int* k0, int* k1,
                                       int* g) {
  const int t8 = nlong + (nshort - nlong + 3) / 4;
  if (t < nlong) {
    *k0 = t;
    *k1 = t + 1;
    *g = 32;
  } else if (t < t8) {
    *k0 = nlong + 4 * (t - nlong);
    *k1 = min(*k0 + 4, nshort);
    *g = 8;
  } else {
    *k0 = nshort + 32 * (t - t8);
    *k1 = min(*k0 + 32, outputs);
    *g = 1;
  }
}

// order: output of each rank; rank k's list is [start[k], start[k + 1])
// of val (f32) and node (box node b); a warp a task.
__global__ void __launch_bounds__(SAAMGE_THREADS)
    contract_R_kernel(const int* __restrict__ order,
                      const int* __restrict__ start,
                      const float* __restrict__ val,
                      const int16_t* __restrict__ node, int NB, int tasks,
                      int nlong, int nshort, int outputs,
                      const float* __restrict__ boxes,
                      float* __restrict__ y) {
  const int task = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= tasks) return;  // whole warps
  const int lane = threadIdx.x & 31;
  int k0, k1, g;
  R_task(task, nlong, nshort, outputs, &k0, &k1, &g);
  const int k = k0 + lane / g, lig = lane & (g - 1);
  float acc = 0.f;
  int o = 0;
  if (k < k1) {
    o = order[k];
    const int n = o % NB, e = start[k + 1];
#pragma unroll 4
    for (int j = start[k] + lig; j < e; j += g)
      acc += val[j] * boxes[node[j] * NB + n];
  }
  for (int off = g >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (k < k1 && lig == 0) y[o] = acc;
}

// rng: the (2, box, NB) slot ranges [lo, hi) of each column.
template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    contract_P_kernel(const V* __restrict__ Rst,
                      const uint8_t* __restrict__ rng, int box, int NB,
                      const float* __restrict__ xc, float* __restrict__ C) {
  const int boxNB = box * NB;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= boxNB) return;
  const int n = t % NB;
  const int hi = rng[boxNB + t];
  float acc = 0.f;
  for (int c = rng[t]; c < hi; ++c)
    acc += ld(Rst, c * boxNB + t) * xc[c * NB + n];
  C[t] = acc;
}

// plan: threads, blocks, nlong, nshort, outputs (ops/contract
// contract_R_plan); the launcher recomputes the task count.
extern "C" int saamge_contract_R(const int* order, const int* start,
                                 const float* val, const int16_t* node,
                                 int NB, const int* plan, const float* boxes,
                                 float* y, void* stream) {
  const int threads = plan[0], blocks = plan[1], nlong = plan[2],
            nshort = plan[3], outputs = plan[4];
  if (NB < 1 || outputs < NB || outputs % NB || nlong < 0 ||
      nshort < nlong || outputs < nshort || (long)outputs * 32 > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const long tasks = nlong + (nshort - nlong + 3) / 4 +
                     (outputs - nshort + 31) / 32;
  if (threads < 32 || threads > SAAMGE_THREADS || threads % 32 ||
      blocks != (tasks * 32 + threads - 1) / threads)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  contract_R_kernel<<<blocks, threads, 0, s>>>(order, start, val, node, NB,
                                               (int)tasks, nlong, nshort,
                                               outputs, boxes, y);
  return (int)cudaGetLastError();
}

extern "C" int saamge_contract_P(int rst_bf16, const void* Rst,
                                 const uint8_t* rng, int bs, int box, int NB,
                                 const float* xc, float* C, void* stream) {
  // the kernel's 32-bit offsets: Rst and the table
  if (bs < 1 || bs > 255 || box < 1 || NB < 1 ||
      (long)bs * box * NB > 0x7fffffffL || 2L * box * NB > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(((long)box * NB + SAAMGE_THREADS - 1) /
                             SAAMGE_THREADS));
  if (rst_bf16)
    contract_P_kernel<<<grid, SAAMGE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)Rst, rng, box, NB, xc, C);
  else
    contract_P_kernel<<<grid, SAAMGE_THREADS, 0, s>>>((const float*)Rst, rng,
                                                      box, NB, xc, C);
  return (int)cudaGetLastError();
}
