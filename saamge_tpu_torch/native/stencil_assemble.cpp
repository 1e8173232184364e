// Native structured-grid stencil assembly + CSR emission with inline
// zero-Dirichlet elimination.
//
// The python slab-add assembly (fem/assemble.py
// assemble_global_stencil_grid) is already fully vectorized, but at
// 17M dofs the numpy strided slab adds + the (n, 27) nonzero() CSR
// construction + the separate BC elimination pass cost ~45 s on the
// 1-core setup host.  This is the reference's own situation — its
// assembly is native MFEM C++ (fem.cpp:453-484
// fem_build_discrete_problem) — so the hot loops live here as a small
// ctypes library (same pattern as partition.cpp), with the python
// implementation kept as the semantics reference and fallback.
//
// Parity: stencil_diagonals applies the same (a, b)-ordered slab adds
// as the numpy version (same summation order; -O3 FMA contraction
// leaves ~1 ulp differences); stencil_csr walks rows in order emitting
// offsets ascending — the exact layout scipy builds from the
// nonzero() mask (touched == "neighbor node exists", separable per
// axis), so patterns are identical.

#include <cstdint>
#include <cstring>

extern "C" {

// data: (k, ndofs) zero-initialized diagonal storage
// em0: (8, 8); c: (nx*ny*nz) per-element factors or nullptr
// shifts: (8, 3) corner offsets of the local dofs
// pos: (8, 8) diagonal index of each local pair
void stencil_diagonals(const double* em0, const double* c,
                       int64_t nx, int64_t ny, int64_t nz,
                       const int64_t* shifts, const int64_t* pos,
                       int64_t k, double* data) {
    const int64_t ndx = nx + 1, ndy = ny + 1, ndz = nz + 1;
    const int64_t ndofs = ndx * ndy * ndz;
    (void)k;
    for (int a = 0; a < 8; ++a) {
        const int64_t dxa = shifts[3 * a], dya = shifts[3 * a + 1],
                      dza = shifts[3 * a + 2];
        for (int b = 0; b < 8; ++b) {
            double* d = data + pos[8 * a + b] * ndofs;
            const double w = em0[8 * a + b];
            if (c == nullptr) {
                for (int64_t i = 0; i < nx; ++i) {
                    for (int64_t j = 0; j < ny; ++j) {
                        double* row = d + ((i + dxa) * ndy + (j + dya))
                                      * ndz + dza;
                        for (int64_t l = 0; l < nz; ++l)
                            row[l] += w;
                    }
                }
            } else {
                for (int64_t i = 0; i < nx; ++i) {
                    for (int64_t j = 0; j < ny; ++j) {
                        const double* ce = c + (i * ny + j) * nz;
                        double* row = d + ((i + dxa) * ndy + (j + dya))
                                      * ndz + dza;
                        for (int64_t l = 0; l < nz; ++l)
                            row[l] += w * ce[l];
                    }
                }
            }
        }
    }
}

// CSR emission with optional zero-Dirichlet elimination:
// entries (i, j) with ess[i] or ess[j] become 0 except the diagonal,
// which keeps its assembled value (keep_diag, x0 == 0 case of
// eliminate_essential_bc).  offsets/off3 ascending; returns nnz.
int64_t stencil_csr(const double* data, int64_t k,
                    const int64_t* offsets, const int64_t* off3,
                    int64_t ndx, int64_t ndy, int64_t ndz,
                    const uint8_t* ess,
                    int32_t* indices, double* vals, int64_t* indptr) {
    const int64_t ndofs = ndx * ndy * ndz;
    int64_t nnz = 0;
    indptr[0] = 0;
    int64_t i = 0;
    for (int64_t ix = 0; ix < ndx; ++ix) {
        for (int64_t iy = 0; iy < ndy; ++iy) {
            for (int64_t iz = 0; iz < ndz; ++iz, ++i) {
                const bool ei = ess != nullptr && ess[i];
                for (int64_t o = 0; o < k; ++o) {
                    const int64_t ox = off3[3 * o],
                                  oy = off3[3 * o + 1],
                                  oz = off3[3 * o + 2];
                    const int64_t jx = ix + ox, jy = iy + oy,
                                  jz = iz + oz;
                    if (jx < 0 || jx >= ndx || jy < 0 || jy >= ndy
                        || jz < 0 || jz >= ndz)
                        continue;
                    const int64_t col = i + offsets[o];
                    double v = data[o * ndofs + i];
                    if (ess != nullptr && (ei || ess[col])
                        && col != i)
                        v = 0.0;
                    indices[nnz] = (int32_t)col;
                    vals[nnz] = v;
                    ++nnz;
                }
                indptr[i + 1] = nnz;
            }
        }
    }
    return nnz;
}

}  // extern "C"
