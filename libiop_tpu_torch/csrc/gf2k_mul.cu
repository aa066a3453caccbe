// K16: batched GF(2^k) product, square and inverse.
//
// Replaces the JAX reference's BinaryField.mul (libiop_tpu/fields/binary.py:
// 249, also mul_scalar), square (:323) and inv (:390; pow_static :364 is a
// chain of these): the carry-less product emulated by masked 32-bit
// integer multiplies over 16-bit pieces, reduced in two word-level passes,
// that XLA fused over (W, batch) uint32 rows.
//
// Design (first, simple): one thread per output element.  mul reads its two
// operands with the (i / div) % mod broadcast of K1 (equal shapes, a
// broadcast scalar, row or column), forms the 2W-word carry-less product by
// a Horner scheme over the 32 bit positions of a's words (a mask and an AND
// and XOR per word of b; gf2k.cuh) and folds it through the pentanomial's
// taps.  square interleaves zeros (linear in characteristic 2) and reduces.
// inv runs the reference's Itoh-Tsujii chain in registers, one launch for
// the whole chain.  Instantiated for W = 2, 4, 6, 8.
//
// Bound on the H100: integer instructions.  The Horner product costs about
// 32 (6W + 3W + 2W^2) instructions (4,000 at W = 6) against 12W bytes
// moved; an inverse costs k - 1 squarings and ~log2(k) + popcount(k-1)
// products.  A 4-bit-window comb on 64-bit words would need several times
// fewer instructions (later work, chosen by measurement).
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

enum : int { kMul = 0, kSquare = 1, kInv = 2 };

template <int W>
__global__ void gf2k_mul_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, size_t n,
                                size_t a_div, size_t a_mod, size_t b_div,
                                size_t b_mod, gf::Taps T) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[W], y[W];
  gf::load<W>(x, a, a_mod, (i / a_div) % a_mod);
  gf::load<W>(y, b, b_mod, (i / b_div) % b_mod);
  gf::mul<W>(x, x, y, T);
  gf::store<W>(out, n, i, x);
}

template <int W>
__global__ void gf2k_unary_kernel(uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ a, size_t n,
                                  int op, gf::Taps T) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[W];
  gf::load<W>(x, a, n, i);
  if (op == kSquare)
    gf::square<W>(x, x, T);
  else
    gf::inv<W>(x, x, T);
  gf::store<W>(out, n, i, x);
}

template <int W>
int launch(int op, void* out, const void* a, const void* b, long long n,
           long long a_div, long long a_mod, long long b_div, long long b_mod,
           const uint32_t* taps, void* stream) {
  const int threads = 128;
  const gf::Taps T = gf::taps_from(taps);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (op != kMul && op != kSquare && op != kInv)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (op == kMul)
      gf2k_mul_kernel<W><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (size_t)n,
          (size_t)a_div, (size_t)a_mod, (size_t)b_div, (size_t)b_mod, T);
    else
      gf2k_unary_kernel<W><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          (uint32_t*)out, (const uint32_t*)a, (size_t)n, op, T);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op 0: out = a * b (broadcast maps as K1); op 1: out = a^2; op 2:
// out = a^-1 (b and the maps unused)
extern "C" int gf2k_mul_launch(int op, void* out, const void* a,
                               const void* b, long long n, long long a_div,
                               long long a_mod, long long b_div,
                               long long b_mod, int words,
                               const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch, op, out, a, b, n, a_div, a_mod, b_div,
                    b_mod, taps, stream)
}
