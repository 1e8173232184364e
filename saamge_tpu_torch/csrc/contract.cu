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
// Bound on this card: device-memory bytes of Rst (bs x box x NB values,
// read once per apply; 2 FLOP per value).  Design: R has one thread per
// (c, n) looping over b, P one thread per (b, n) looping over c.
// Consecutive threads take consecutive bricks n, so every Rst, boxes and
// xc load of a warp is one coalesced 128-byte line.  R runs only bs x NB
// threads (34,560 at the n=96 flagship with bs=20), each streaming 729
// values: latency more than bandwidth limits it, which a split of the b
// loop across a warp would cure (later work).
#include "common.cuh"

template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    contract_R_kernel(const V* __restrict__ Rst, int bs, int box, int NB,
                      const float* __restrict__ boxes,
                      float* __restrict__ y) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)bs * NB) return;
  const int c = (int)(t / NB), n = (int)(t % NB);
  const V* R = Rst + (long)c * box * NB + n;
  const float* x = boxes + n;
  float acc = 0.f;
  for (int b = 0; b < box; ++b) acc += ld(R, (long)b * NB) * x[(long)b * NB];
  y[t] = acc;
}

template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    contract_P_kernel(const V* __restrict__ Rst, int bs, int box, int NB,
                      const float* __restrict__ xc, float* __restrict__ C) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)box * NB) return;
  const int n = (int)(t % NB);
  const long boxNB = (long)box * NB;
  float acc = 0.f;
  for (int c = 0; c < bs; ++c)
    acc += ld(Rst, c * boxNB + t) * xc[(long)c * NB + n];
  C[t] = acc;
}

static dim3 grid_for(long work) {
  return dim3((unsigned)((work + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
}

// mode 0: R (x = boxes (box, NB), out = y (bs, NB));
// mode 1: P (x = xc (bs, NB), out = C (box, NB)).
extern "C" int saamge_contract(int mode, int rst_bf16, const void* Rst,
                               int bs, int box, int NB, const float* x,
                               float* out, void* stream) {
  if (bs < 1 || box < 1 || NB < 1 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_for(mode == 0 ? (long)bs * NB : (long)box * NB);
  if (mode == 0) {
    if (rst_bf16)
      contract_R_kernel<<<grid, SAAMGE_THREADS, 0, s>>>(
          (const __nv_bfloat16*)Rst, bs, box, NB, x, out);
    else
      contract_R_kernel<<<grid, SAAMGE_THREADS, 0, s>>>(
          (const float*)Rst, bs, box, NB, x, out);
  } else {
    if (rst_bf16)
      contract_P_kernel<<<grid, SAAMGE_THREADS, 0, s>>>(
          (const __nv_bfloat16*)Rst, bs, box, NB, x, out);
    else
      contract_P_kernel<<<grid, SAAMGE_THREADS, 0, s>>>(
          (const float*)Rst, bs, box, NB, x, out);
  }
  return (int)cudaGetLastError();
}
