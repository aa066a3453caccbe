// K6: reduction of a lazy int64 limb accumulator to one canonical field
// element per column, in one launch.
//
// Replaces the JAX reference's PrimeField.mont_reduce_wide
// (libiop_tpu/fields/prime.py:361) and lazy_sum_reduce (:402): the sum behind
// every linear combination, matvec row and vanishing division is kept as K
// limb rows of 16-bit weight summed without carries, then reduced 16 bits at
// a time (L Montgomery steps, a carry pass and a conditional subtraction).
// lazy_sum_reduce then re-enters Montgomery form with a second product by
// R^2; here both are one launch.
//
// Input t: int64 (K, n), K <= 2L + 2 (26 for L = 12, 34 for L = 16), every
// column in [0, 2^63); the value of column i is V = sum_k t[k][i] * 2^(16k).
// Output: (L, n) int32,
// the canonical limbs of V * c, where the caller picks
//   mont_reduce_wide: V * R^-1 mod p      (c = (1, R, R^2) below)
//   lazy_sum_reduce:  V mod p             (c = (R, R^2, R^3))
// with R = 2^(32W) and the c constants reduced mod p (W = L/2 words:
// instantiated for W = 6, edwards_Fr, and W = 8, alt_bn128_Fr).
//
// Design (first, simple): one thread per column.  A carry pass turns the K
// rows into 16-bit digits (the running carry stays below 2^48, so it fits in
// 64 bits next to a column below 2^63) and packs them into 3W 32-bit words,
// V = A0 + A1 * R + A2 * R^2 with A0, A1, A2 < R.  Then
// V * c0 * R^-1 = mont(A0, c0) + mont(A1, c1) + mont(A2, c2) mod p, three
// CIOS products (each a * b < p * R, so each result is canonical after one
// conditional subtraction) and two modular adds.  The canonical result is
// unique, so it equals the plain 16-bit-step reduction limb for limb
// wherever that one is exact (V < p * R, which every caller meets).
//
// Bound on the H100: memory for K = L (8L bytes in, 4L out per column
// against three products' integer instructions), operations for larger K
// only when the card's integer rate falls below ~10 ops per byte.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
struct Consts {
  uint32_t c[3][W];
};

template <int W>
__global__ void lazy_reduce_kernel(uint32_t* __restrict__ out,
                                   const long long* __restrict__ t, int K,
                                   size_t n, Consts<W> C, fp::Params<W> P) {
  constexpr int kMaxRows = 4 * W + 2;  // 2L + 2
  constexpr int kWords = 3 * W;        // >= (kMaxRows + 3) digits / 2
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = 0;
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < kMaxRows + 3; ++k) {
    if (k < K) acc += (uint64_t)t[(size_t)k * n + i];
    w[k >> 1] |= (uint32_t)(acc & 0xffffu) << (16 * (k & 1));
    acc >>= 16;
  }
  uint32_t r[W], s[W];
  fp::mont_mul<W>(r, w, C.c[0], P);
  fp::mont_mul<W>(s, w + W, C.c[1], P);
  fp::add_mod<W>(r, r, s, P);
  fp::mont_mul<W>(s, w + 2 * W, C.c[2], P);
  fp::add_mod<W>(r, r, s, P);
  fp::store<W>(out, n, i, r);
}

template <int W>
int launch(void* out, const void* t, int K, long long n,
           const uint32_t* consts, const uint32_t* field, void* stream) {
  if (K < 1 || K > 4 * W + 2) return (int)cudaErrorInvalidValue;
  Consts<W> C;
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < W; ++j) C.c[k][j] = consts[k * W + j];
  const int threads = 256;
  if (n > 0)
    lazy_reduce_kernel<W><<<(unsigned)((n + threads - 1) / threads), threads,
                            0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const long long*)t, K, (size_t)n, C,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

// consts: 3W uint32 words, c0 c1 c2 as W little-endian 32-bit limbs each
extern "C" int lazy_reduce_launch(void* out, const void* t, int K, long long n,
                                  const uint32_t* consts, int words,
                                  const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, t, K, n, consts, field, stream)
}
