// Kernel 3: the tent restriction R and prolongation P between the fine
// node grid and the slot-major padded coarse layout (coarse dof
// (brick p, slot s) at s * NB + p).
//
//   R:  yc[s, p] = sum_w Rst[s, w, p] * r[window(p, w)]
//   P:  y[g]     = sum over bricks p whose closed box holds node g of
//                  sum_s Rst[s, w(p, g), p] * xc[s, p]
//
// where window(p, w) is node w of brick p's closed (bx+1)(by+1)(bz+1)
// box.  Rst is the slot-major (bs, box, NB) tent array, f32 or bf16.
//
// Replaces: saamge_tpu/ops/pallas_window.py `_build_window_R` and
// `_build_window_P` (+ the XLA overlap-add fold_pieces).  The TPU kernels
// window z with 0/1 selection matmuls on the MXU and so truncate window
// values and per-slot partial sums to bf16; here the windows are plain
// index arithmetic, Rst is widened to f32 and r, xc and all sums stay
// f32 -- the numerics of the XLA apply_R / apply_P with a bf16 Rst.
//
// Bound on this card: device-memory bytes of Rst (bs x 729 x NB values,
// 50 MB in bf16 at the n=96 flagship) read once per apply.
// Design.  R: one thread per (s, p); consecutive threads take
// consecutive bricks p, so every Rst read is coalesced; the node reads
// of neighbouring bricks fall bz apart and are served by L1/L2.
// P (gather form, no atomics): one thread per fine node, visiting the
// <= 8 bricks whose closed box holds it -- along each axis coordinate g
// lies in brick g/b at local g%b, and also in brick g/b - 1 at local b
// when g%b == 0 and g > 0.  Threads are ordered so that consecutive
// threads take the same local z in consecutive z-bricks, which keeps
// the Rst and xc reads coalesced.  Shared planes are summed, so the
// overlap-add of fold_pieces disappears.
#include "common.cuh"

struct WinGeom {
  int BX, BY, BZ;  // bricks per axis
  int bx, by, bz;  // elements per brick per axis
  int bs;          // slots per brick
};

template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    window_R_kernel(const V* __restrict__ Rst, WinGeom g,
                    const float* __restrict__ r, float* __restrict__ yc) {
  const int NB = g.BX * g.BY * g.BZ;
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)g.bs * NB) return;
  const int s = (int)(t / NB), p = (int)(t % NB);
  const int pz = p % g.BZ, py = (p / g.BZ) % g.BY, px = p / (g.BY * g.BZ);
  const long NYn = (long)g.BY * g.by + 1, NZn = (long)g.BZ * g.bz + 1;
  const long box = (long)(g.bx + 1) * (g.by + 1) * (g.bz + 1);
  const V* R = Rst + (long)s * box * NB + p;
  float acc = 0.f;
  long w = 0;
  for (int u = 0; u <= g.bx; ++u)
    for (int v = 0; v <= g.by; ++v) {
      const float* row =
          r + ((long)(px * g.bx + u) * NYn + (py * g.by + v)) * NZn +
          (long)pz * g.bz;
      for (int z = 0; z <= g.bz; ++z, ++w) acc += ld(R, w * NB) * row[z];
    }
  yc[t] = acc;
}

template <typename V>
__global__ void __launch_bounds__(SAAMGE_THREADS)
    window_P_kernel(const V* __restrict__ Rst, WinGeom g,
                    const float* __restrict__ xc, float* __restrict__ y) {
  const int NB = g.BX * g.BY * g.BZ;
  const long NYn = (long)g.BY * g.by + 1, NZn = (long)g.BZ * g.bz + 1;
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ((long)g.BX * g.bx + 1) * NYn * NZn) return;
  const int j = (int)(t % NZn);
  const long xy = t / NZn;
  const int gy = (int)(xy % NYn), gx = (int)(xy / NYn);
  // j enumerates z as (local z, brick z) with brick z fastest; the last
  // plane gz = BZ*bz comes last
  const int zlast = g.BZ * g.bz;
  const int gz = j < zlast ? (j % g.BZ) * g.bz + j / g.BZ : zlast;
  // per axis: up to two (brick, local) pairs whose closed box holds g
  int cb[3][2], cl[3][2], nc[3];
  const int gc[3] = {gx, gy, gz}, bb[3] = {g.bx, g.by, g.bz},
            BB[3] = {g.BX, g.BY, g.BZ};
  for (int a = 0; a < 3; ++a) {
    nc[a] = 0;
    if (gc[a] < BB[a] * bb[a]) {
      cb[a][nc[a]] = gc[a] / bb[a];
      cl[a][nc[a]] = gc[a] % bb[a];
      ++nc[a];
    }
    if (gc[a] % bb[a] == 0 && gc[a] > 0) {
      cb[a][nc[a]] = gc[a] / bb[a] - 1;
      cl[a][nc[a]] = bb[a];
      ++nc[a];
    }
  }
  const long box = (long)(g.bx + 1) * (g.by + 1) * (g.bz + 1);
  float acc = 0.f;
  for (int ia = 0; ia < nc[0]; ++ia)
    for (int ib = 0; ib < nc[1]; ++ib)
      for (int ic = 0; ic < nc[2]; ++ic) {
        const int p = (cb[0][ia] * g.BY + cb[1][ib]) * g.BZ + cb[2][ic];
        const long w =
            ((long)cl[0][ia] * (g.by + 1) + cl[1][ib]) * (g.bz + 1) +
            cl[2][ic];
        for (int s = 0; s < g.bs; ++s)
          acc += ld(Rst, ((long)s * box + w) * NB + p) * xc[(long)s * NB + p];
      }
  y[(xy * NZn) + gz] = acc;
}

static WinGeom make_geom(const int* geom) {
  WinGeom g;
  g.BX = geom[0];
  g.BY = geom[1];
  g.BZ = geom[2];
  g.bx = geom[3];
  g.by = geom[4];
  g.bz = geom[5];
  g.bs = geom[6];
  return g;
}

static dim3 blocks_for(long work) {
  return dim3((unsigned)((work + SAAMGE_THREADS - 1) / SAAMGE_THREADS));
}

extern "C" int saamge_window_R(int rst_bf16, const void* Rst,
                               const int* geom, const float* r, float* yc,
                               void* stream) {
  WinGeom g = make_geom(geom);
  long work = (long)g.bs * g.BX * g.BY * g.BZ;
  cudaStream_t s = (cudaStream_t)stream;
  if (rst_bf16)
    window_R_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)Rst, g, r, yc);
  else
    window_R_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const float*)Rst, g, r, yc);
  return (int)cudaGetLastError();
}

extern "C" int saamge_window_P(int rst_bf16, const void* Rst,
                               const int* geom, const float* xc, float* y,
                               void* stream) {
  WinGeom g = make_geom(geom);
  long work = ((long)g.BX * g.bx + 1) * ((long)g.BY * g.by + 1) *
              ((long)g.BZ * g.bz + 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (rst_bf16)
    window_P_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)Rst, g, xc, y);
  else
    window_P_kernel<<<blocks_for(work), SAAMGE_THREADS, 0, s>>>(
        (const float*)Rst, g, xc, y);
  return (int)cudaGetLastError();
}
