// K15: row inner product out[j] = sum_i a[i, j] * b[i, j] mod p over R rows,
// where b is a full (R, N) array or one element per row (R, 1).
//
// Replaces the JAX reference's _row_sum (libiop_tpu/protocols/ligero.py:92:
// a limb-wise lazy sum over the row axis and one wide reduction) together
// with the F.mul that feeds it (ligero.py:198-200), which writes and
// re-reads an (R, N) product array; and its lazy_linear_combination
// (libiop_tpu/protocols/common.py:18) when b holds one scalar per row.
//
// Design (first, simple): one thread per output column j.  It accumulates
// the rows' full 2W-word products a*b lazily in 2W+1 words (mul_wide_acc
// of csrc/field.cuh) and reduces once (redc_wide): the Montgomery forms
// multiply to (sum x_i y_i) R^2, whose reduction is the Montgomery form of
// the sum.  redc_wide takes T < p * 2^(32W), that is at most `cap` products
// of values below p (the launcher's argument, computed by the wrapper from
// p: 4043 at edwards_Fr, 5 at alt_bn128_Fr).  When the accumulator holds
// `cap` products it is folded: T' = redc_wide(T) * (2^(32W) mod p), a
// single product that reduces to the same value, and the rows go on.  The
// launcher refuses cap < 2, where no fold leaves room for a product.  The
// product array is never written.
//
// Bound on the H100: memory at the paths' shapes (each column reads 2R
// elements of 8W bytes (R + 1 with scalar rows) against R wide products
// and one reduction, about 225 integer instructions per 48 bytes at W = 6).
//
// GF(2^k) instantiation (W = 2, 4, 6, 8 words; the reference's XOR branch
// of _row_sum, ligero.py:96-100, with its K16 products): the same one
// thread per column.  Reduction modulo the pentanomial is linear over
// GF(2), so the thread XORs the rows' unreduced 2W-word carry-less
// products (gf::clmul of csrc/gf2k.cuh) and reduces once; no fold is ever
// needed.  Integer-instruction bound: the Horner clmul costs about
// 32 (4 W^2 + 2 W) instructions a product against 8W bytes of reads.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

template <int W>
__global__ void row_dot_kernel(uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b, size_t R,
                               size_t N, size_t nb, int cap,
                               const uint32_t* __restrict__ r_mod_p,
                               fp::Params<W> P) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const size_t bj = nb == 1 ? 0 : j;
  uint32_t acc[2 * W + 1];
#pragma unroll
  for (int k = 0; k < 2 * W + 1; ++k) acc[k] = 0;
  int held = 0;  // products in acc
  for (size_t i = 0; i < R; ++i) {
    if (held == cap) {
      uint32_t folded[W], rm[W];
      fp::redc_wide<W>(folded, acc, P);
      fp::load<W>(rm, r_mod_p, 1, 0);
#pragma unroll
      for (int k = 0; k < 2 * W + 1; ++k) acc[k] = 0;
      fp::mul_wide_acc<W>(acc, folded, rm);
      held = 1;
    }
    uint32_t x[W], y[W];
    fp::load<W>(x, a, R * N, i * N + j);
    fp::load<W>(y, b, R * nb, i * nb + bj);
    fp::mul_wide_acc<W>(acc, x, y);
    ++held;
  }
  uint32_t res[W];
  fp::redc_wide<W>(res, acc, P);
  fp::store<W>(out, N, j, res);
}

template <int W>
int launch(void* out, const void* a, const void* b, long long R, long long N,
           long long nb, int cap, const void* r_mod_p, const uint32_t* field,
           void* stream) {
  if (cap < 2) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  if (N > 0)
    row_dot_kernel<W><<<(unsigned)((N + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (size_t)R,
        (size_t)N, (size_t)nb, cap, (const uint32_t*)r_mod_p,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void row_dot_gf2_kernel(uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ a,
                                   const uint32_t* __restrict__ b, size_t R,
                                   size_t N, size_t nb, gf::Taps T) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const size_t bj = nb == 1 ? 0 : j;
  uint32_t acc[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) acc[k] = 0;
  for (size_t i = 0; i < R; ++i) {
    uint32_t x[W], y[W], t[2 * W];
    gf::load<W>(x, a, R * N, i * N + j);
    gf::load<W>(y, b, R * nb, i * nb + bj);
    gf::clmul<W>(t, x, y);
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) acc[k] ^= t[k];
  }
  uint32_t res[W];
  gf::reduce<W>(res, acc, T);
  gf::store<W>(out, N, j, res);
}

template <int W>
int launch_gf2(void* out, const void* a, const void* b, long long R,
               long long N, long long nb, const uint32_t* taps,
               void* stream) {
  const int threads = 128;
  if (N > 0)
    row_dot_gf2_kernel<W><<<(unsigned)((N + threads - 1) / threads), threads,
                            0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (size_t)R,
        (size_t)N, (size_t)nb, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

}  // namespace

// a: (2W, R, N); b: (2W, R, nb) with nb = N or 1; r_mod_p: (2W, 1) limbs
// of 2^(32W) mod p; cap: the most products the accumulator may hold;
// out: (2W, N)
extern "C" int row_dot_launch(void* out, const void* a, const void* b,
                              long long R, long long N, long long nb, int cap,
                              const void* r_mod_p, int words,
                              const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, a, b, R, N, nb, cap, r_mod_p, field,
                    stream)
}

// GF(2^k): a: (W, R, N) words; b: (W, R, nb); taps: the field's four
// reduction taps; out: (W, N)
extern "C" int row_dot_gf2_launch(void* out, const void* a, const void* b,
                                  long long R, long long N, long long nb,
                                  int words, const uint32_t* taps,
                                  void* stream) {
  GF_DISPATCH_WORDS(words, launch_gf2, out, a, b, R, N, nb, taps, stream)
}
