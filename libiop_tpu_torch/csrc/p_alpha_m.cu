// K21: the holographic lincheck's p_alpha * M product,
// out[:, c] = sum_M r_M (M^T p)[inv[c]] where inv[c] < S, zero where
// inv[c] == S, for up to kMaxMats matrices of S columns.
//
// Replaces the JAX reference's compute_p_alpha_M_evals
// (libiop_tpu/protocols/holographic_lincheck.py:134): per matrix a
// transpose matvec of p_alpha over H (sparse.py matvec_transpose), a
// product by r_M, a sum over the matrices, zero padding to |H| and
// place_columns into the variable slots of the summation domain
// (Hs.reindex_by_subgroup(input_variable_dim, j)), all fused by XLA.  The
// port could compose it from K7, K1, K5 and K13; K21 is that composition in
// one launch that writes nothing but its output.
//
// Design: a group of G lanes (G a power of two <= 32, chosen by the wrapper
// from the densest column, 1 for the balanced matrices of the paths) per
// output slot c.  The group reads its column j = inv[c] of the memoized
// inverse placement; for each matrix it walks column j of M^T in CSR form
// (relations/sparse.py transpose_csr_device: offsets per column, then per
// nonzero its value, stored by column, and its row, src, into p; no
// padding, so a dense column costs its own nonzeros and no memory beyond
// them), each lane every G-th nonzero.  A lane sums the full 2W-word products val * p lazily
// in 2W+1 words and reduces once (mul_wide_acc and redc_wide of
// csrc/field.cuh: the Montgomery forms multiply to (sum val p) R^2, whose
// reduction is the Montgomery form of the sum), folding the accumulator as
// K15 does when it holds `cap` products; the group adds its lanes' sums by
// shuffles, then one CIOS product by r_M and a modular add.
//
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: memory at the paths' shapes (per nonzero 8W bytes of
// vals and 8 of src, p read once, against one wide product, half a CIOS
// product); the p gathers are scattered.
//
// GF(2^k) instantiation (W = 2, 4, 6, 8 words; the reference's function
// over a binary field): the same Args, the same groups and the same walk
// of M^T in CSR form.  Reduction modulo the pentanomial is linear over
// GF(2), so a lane XORs its nonzeros' unreduced 2W-word carry-less
// products (gf::clmul of csrc/gf2k.cuh), the group XORs its lanes'
// accumulators by shuffles, and lane 0 reduces once a matrix, multiplies
// by r_M (its canonical words in Matrix::r) and XORs the matrices' terms.
// No fold is ever needed.  Integer-instruction bound: a Horner clmul of
// about 32 (4 W^2 + 2 W) instructions a nonzero against 8W + 8 bytes.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

constexpr int kMaxMats = 4;

struct Matrix {
  const uint32_t* vals;      // (2W, nvals) Montgomery limbs, by column
  long long nvals;
  const long long* offsets;  // (S + 1) column starts into vals and src
  const long long* src;      // (nvals) indices into p
  uint32_t r[fp::kMaxWords];  // r_M: Montgomery form, or GF(2^k) words
};

struct Args {
  Matrix m[kMaxMats];
  int n_mats;
  const uint32_t* p;  // (2W, np)
  long long np;
  const long long* inv;  // (nv) inverse placement, S the zero sentinel
  long long S;
  long long nv;
  int cap;    // prime fields only
  int group;  // G lanes a slot
  const uint32_t* r_mod_p;  // (2W, 1) limbs of 2^(32W) mod p; prime only
};

template <int W>
__global__ void p_alpha_m_kernel(uint32_t* __restrict__ out, Args A,
                                 fp::Params<W> P) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int G = A.group;
  const int lane = (int)(t % G);
  const size_t c = t / G;
  // every lane of a warp reaches the shuffles below, so none returns early
  const bool live = c < (size_t)A.nv;
  const long long j = live ? A.inv[c] : A.S;
  uint32_t total[W];
  fp::set_zero<W>(total);
  for (int mi = 0; mi < A.n_mats; ++mi) {
    const Matrix& M = A.m[mi];
    uint32_t v[W];
    fp::set_zero<W>(v);
    if (j < A.S) {
      uint32_t acc[2 * W + 1];
#pragma unroll
      for (int k = 0; k < 2 * W + 1; ++k) acc[k] = 0;
      int held = 0;
      const long long end = M.offsets[j + 1];
      for (long long k = M.offsets[j] + lane; k < end; k += G) {
        if (held == A.cap) {
          uint32_t folded[W], rm[W];
          fp::redc_wide<W>(folded, acc, P);
          fp::load<W>(rm, A.r_mod_p, 1, 0);
#pragma unroll
          for (int q = 0; q < 2 * W + 1; ++q) acc[q] = 0;
          fp::mul_wide_acc<W>(acc, folded, rm);
          held = 1;
        }
        uint32_t x[W], y[W];
        fp::load<W>(x, M.vals, (size_t)M.nvals, (size_t)k);
        fp::load<W>(y, A.p, (size_t)A.np, (size_t)M.src[k]);
        fp::mul_wide_acc<W>(acc, x, y);
        ++held;
      }
      fp::redc_wide<W>(v, acc, P);
    }
    for (int off = G / 2; off > 0; off /= 2) {
      uint32_t o[W];
#pragma unroll
      for (int q = 0; q < W; ++q)
        o[q] = __shfl_down_sync(0xffffffffu, v[q], off, G);
      fp::add_mod<W>(v, v, o, P);
    }
    uint32_t r[W];
#pragma unroll
    for (int q = 0; q < W; ++q) r[q] = M.r[q];
    fp::mont_mul<W>(v, v, r, P);
    fp::add_mod<W>(total, total, v, P);
  }
  if (live && lane == 0) fp::store<W>(out, (size_t)A.nv, c, total);
}

template <int W>
int launch(void* out, const Args* A, const uint32_t* field, void* stream) {
  const int G = A->group;
  if (A->n_mats < 1 || A->n_mats > kMaxMats || A->cap < 2 || G < 1 ||
      G > 32 || (G & (G - 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long total = A->nv * G;
  if (total > 0)
    p_alpha_m_kernel<W><<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, *A, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void p_alpha_m_gf2_kernel(uint32_t* __restrict__ out, Args A,
                                     gf::Taps T) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int G = A.group;
  const int lane = (int)(t % G);
  const size_t c = t / G;
  // every lane of a warp reaches the shuffles below, so none returns early
  const bool live = c < (size_t)A.nv;
  const long long j = live ? A.inv[c] : A.S;
  uint32_t total[W];
  gf::set_zero<W>(total);
  for (int mi = 0; mi < A.n_mats; ++mi) {
    const Matrix& M = A.m[mi];
    uint32_t acc[2 * W];
#pragma unroll
    for (int q = 0; q < 2 * W; ++q) acc[q] = 0;
    if (j < A.S) {
      const long long end = M.offsets[j + 1];
      for (long long k = M.offsets[j] + lane; k < end; k += G) {
        uint32_t x[W], y[W], prod[2 * W];
        gf::load<W>(x, M.vals, (size_t)M.nvals, (size_t)k);
        gf::load<W>(y, A.p, (size_t)A.np, (size_t)M.src[k]);
        gf::clmul<W>(prod, x, y);
#pragma unroll
        for (int q = 0; q < 2 * W; ++q) acc[q] ^= prod[q];
      }
    }
    for (int off = G / 2; off > 0; off /= 2) {
#pragma unroll
      for (int q = 0; q < 2 * W; ++q)
        acc[q] ^= __shfl_down_sync(0xffffffffu, acc[q], off, G);
    }
    uint32_t v[W], r[W];
    gf::reduce<W>(v, acc, T);
#pragma unroll
    for (int q = 0; q < W; ++q) r[q] = M.r[q];
    gf::mul<W>(v, v, r, T);
    gf::add<W>(total, total, v);
  }
  if (live && lane == 0) gf::store<W>(out, (size_t)A.nv, c, total);
}

template <int W>
int launch_gf2(void* out, const Args* A, const uint32_t* taps, void* stream) {
  const int G = A->group;
  if (A->n_mats < 1 || A->n_mats > kMaxMats || G < 1 || G > 32 ||
      (G & (G - 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long total = A->nv * G;
  if (total > 0)
    p_alpha_m_gf2_kernel<W><<<(unsigned)((total + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, *A, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

}  // namespace

// out: (2W, nv) limbs; args: the matrices' CSR plans and r_M, p, the
// inverse placement, the accumulator cap and the group size (see Args)
extern "C" int p_alpha_m_launch(void* out, const void* args, int words,
                                const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, (const Args*)args, field, stream)
}

// GF(2^k): out (W, nv) words; args as above with vals and p in words and
// r_M's canonical words (cap and r_mod_p unused); taps: the field's four
// reduction taps
extern "C" int p_alpha_m_gf2_launch(void* out, const void* args, int words,
                                    const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch_gf2, out, (const Args*)args, taps, stream)
}
