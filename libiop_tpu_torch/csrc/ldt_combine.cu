// K24: the LDT reducer's combination, out[i] = sum_k coeff_k(x_i) f_k[i]
// over n input oracles in one launch, with coeff_k = c_k for an input of
// maximal degree and coeff_k = c_k + c'_k x_i^(Delta_k) for a submaximal
// one.
//
// Replaces the JAX reference's CombinedLDTOracle.evaluated_contents
// (libiop_tpu/protocols/ldt_reducer.py:105, one XLA-fused function over
// 257-262 inputs on Ligero), which the port ran eagerly as two K1/K5 (or
// K16/XOR) launches an input: K8 takes at most 32 inputs.
//
// Inputs are the runtime's oracle tensors as they are, not stacked: on
// Ligero the views cw[:, i, :] of one (L, rows, N) codeword array.  The
// kernel takes a device array of n element pointers with each input's limb
// stride (in 32-bit entries; the evaluation axis is contiguous), the
// coefficients c_k and c'_k in the field's device form, and
// for each input the x^Delta table it uses (a memoized (L, N) codeword) or
// null for a maximal input.
//
// Design (first, simple): one thread an output element walks the n inputs.
//  - Prime fields (W = 6, 8 words): the thread accumulates the full 2W-word
//    products coeff_k * f_k[i] unreduced in 2W + 1 words (mul_wide_acc of
//    csrc/field.cuh) and reduces once (redc_wide): Montgomery forms multiply
//    to (sum coeff f) R^2, whose reduction is the Montgomery form of the
//    sum.  Headroom: redc_wide takes T < p 2^(32W), at most `cap` products
//    of values below p (the wrapper's argument: 4043 at edwards_Fr, so
//    n <= 512 never folds; 5 at alt_bn128_Fr).  When the accumulator holds
//    `cap` products it is folded, T' = redc_wide(T) * (2^(32W) mod p), one
//    product that reduces to the same value, as K15 does.  A submaximal
//    coefficient costs one CIOS product and an addition more.
//  - GF(2^k) (W = 2, 4, 6, 8): reduction modulo the pentanomial is linear,
//    so the thread XORs the unreduced 2W-word carry-less products and folds
//    once, as K7 and K21 do; a submaximal coefficient costs one reduced
//    product and an XOR more.
//
// Bound on the H100: memory on the prime fields at Ligero's shapes (n
// elements read an output against n wide products and one reduction, about
// 150 integer instructions per 48 bytes at W = 6); operations over GF(2^k),
// whose products Hopper computes without a carry-less multiply.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

struct Inputs {
  const unsigned long long* ptrs;     // n element pointers
  const long long* strides;           // n limb strides
  const unsigned long long* tables;   // n x^Delta tables, 0 for none
  const uint32_t* c;  // (L, 2n): c_k in column k, c'_k in column n + k
};

template <int W>
__global__ void ldt_combine_kernel(uint32_t* __restrict__ out, Inputs in,
                                   long long n, long long N, int cap,
                                   const uint32_t* __restrict__ r_mod_p,
                                   fp::Params<W> P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t acc[2 * W + 1];
#pragma unroll
  for (int k = 0; k < 2 * W + 1; ++k) acc[k] = 0;
  int held = 0;  // products in acc
  for (long long k = 0; k < n; ++k) {
    if (held == cap) {
      uint32_t folded[W], rm[W];
      fp::redc_wide<W>(folded, acc, P);
      fp::load<W>(rm, r_mod_p, 1, 0);
#pragma unroll
      for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
      fp::mul_wide_acc<W>(acc, folded, rm);
      held = 1;
    }
    uint32_t f[W], coeff[W];
    fp::load<W>(f, (const uint32_t*)in.ptrs[k], (size_t)in.strides[k],
                (size_t)i);
    fp::load<W>(coeff, in.c, (size_t)(2 * n), (size_t)k);
    if (in.tables[k] != 0) {
      uint32_t bump[W], cp[W];
      fp::load<W>(bump, (const uint32_t*)in.tables[k], (size_t)N, (size_t)i);
      fp::load<W>(cp, in.c, (size_t)(2 * n), (size_t)(n + k));
      fp::mont_mul<W>(bump, bump, cp, P);
      fp::add_mod<W>(coeff, coeff, bump, P);
    }
    fp::mul_wide_acc<W>(acc, coeff, f);
    ++held;
  }
  uint32_t res[W];
  fp::redc_wide<W>(res, acc, P);
  fp::store<W>(out, (size_t)N, (size_t)i, res);
}

template <int W>
int launch(void* out, Inputs in, long long n, long long N, int cap,
           const void* r_mod_p, const uint32_t* field, void* stream) {
  if (cap < 2) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  if (N > 0)
    ldt_combine_kernel<W><<<(unsigned)((N + threads - 1) / threads), threads,
                            0, (cudaStream_t)stream>>>(
        (uint32_t*)out, in, n, N, cap, (const uint32_t*)r_mod_p,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void ldt_combine_gf2_kernel(uint32_t* __restrict__ out, Inputs in,
                                       long long n, long long N, gf::Taps T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t acc[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) acc[k] = 0;
  for (long long k = 0; k < n; ++k) {
    uint32_t f[W], coeff[W], t[2 * W];
    gf::load<W>(f, (const uint32_t*)in.ptrs[k], (size_t)in.strides[k],
                (size_t)i);
    gf::load<W>(coeff, in.c, (size_t)(2 * n), (size_t)k);
    if (in.tables[k] != 0) {
      uint32_t bump[W], cp[W];
      gf::load<W>(bump, (const uint32_t*)in.tables[k], (size_t)N, (size_t)i);
      gf::load<W>(cp, in.c, (size_t)(2 * n), (size_t)(n + k));
      gf::mul<W>(bump, bump, cp, T);
      gf::add<W>(coeff, coeff, bump);
    }
    gf::clmul<W>(t, coeff, f);
#pragma unroll
    for (int j = 0; j < 2 * W; ++j) acc[j] ^= t[j];
  }
  uint32_t res[W];
  gf::reduce<W>(res, acc, T);
  gf::store<W>(out, (size_t)N, (size_t)i, res);
}

template <int W>
int launch_gf2(void* out, Inputs in, long long n, long long N,
               const uint32_t* taps, void* stream) {
  const int threads = 128;
  if (N > 0)
    ldt_combine_gf2_kernel<W><<<(unsigned)((N + threads - 1) / threads),
                                threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, in, n, N, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

Inputs inputs_from(const void* meta, long long n, const void* coeffs) {
  const unsigned long long* m = (const unsigned long long*)meta;
  Inputs in;
  in.ptrs = m;
  in.strides = (const long long*)(m + n);
  in.tables = m + 2 * n;
  in.c = (const uint32_t*)coeffs;
  return in;
}

}  // namespace

// meta: int64 device array [n pointers, n limb strides, n table pointers
// (0: a maximal input)]; coeffs: (L, 2n) device limbs (words over
// GF(2^k)), c_k in column k and c'_k in column n + k; out: (L, N)
extern "C" int ldt_combine_launch(void* out, const void* meta,
                                  const void* coeffs, long long n,
                                  long long N, int cap, const void* r_mod_p,
                                  int words, const uint32_t* field,
                                  void* stream) {
  const Inputs in = inputs_from(meta, n, coeffs);
  FP_DISPATCH_WORDS(words, launch, out, in, n, N, cap, r_mod_p, field,
                    stream)
}

extern "C" int ldt_combine_gf2_launch(void* out, const void* meta,
                                      const void* coeffs, long long n,
                                      long long N, int words,
                                      const uint32_t* taps, void* stream) {
  const Inputs in = inputs_from(meta, n, coeffs);
  GF_DISPATCH_WORDS(words, launch_gf2, out, in, n, N, taps, stream)
}
