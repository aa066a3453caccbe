// K1: batched Montgomery product out = a * b * R^-1 mod p.
//
// Replaces the JAX reference's PrimeField.mul (libiop_tpu/fields/prime.py:317,
// also square / mul_scalar / to_canonical_limbs / from_canonical_limbs): an
// unrolled 16-bit schoolbook product with a 16-bit-step Montgomery reduction
// that XLA fused over (L, batch) uint32 rows (L = 12 or 16).
//
// Design (first, simple): one thread per output element.  Each operand is a
// contiguous (2W, n_op) limb array; the element an output index i reads is
// (i / div) % mod of that operand, which covers equal shapes (div 1, mod n),
// a broadcast scalar (mod 1), a broadcast row (div 1, mod d) and a broadcast
// column (div d, mod rows).  The thread repacks 2W 16-bit limbs into W
// 32-bit limbs, runs the CIOS product (field.cuh) and writes 2W limbs back.
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: memory.  Each element moves 3 x 8W bytes (limbs are
// stored one per int32) against ~8W^2 32-bit integer instructions, so at
// full width the kernel sits near the 3.35 TB/s line; packed 32-bit limbs in
// memory would halve the bytes (later work).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
__global__ void mont_mul_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, size_t n,
                                size_t a_div, size_t a_mod, size_t b_div,
                                size_t b_mod, fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[W], y[W];
  fp::load<W>(x, a, a_mod, (i / a_div) % a_mod);
  fp::load<W>(y, b, b_mod, (i / b_div) % b_mod);
  fp::mont_mul<W>(x, x, y, P);
  fp::store<W>(out, n, i, x);
}

template <int W>
int launch(void* out, const void* a, const void* b, long long n,
           long long a_div, long long a_mod, long long b_div, long long b_mod,
           const uint32_t* field, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    mont_mul_kernel<W><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (size_t)n,
        (size_t)a_div, (size_t)a_mod, (size_t)b_div, (size_t)b_mod,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mont_mul_launch(void* out, const void* a, const void* b,
                               long long n, long long a_div, long long a_mod,
                               long long b_div, long long b_mod, int words,
                               const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, a, b, n, a_div, a_mod, b_div, b_mod,
                    field, stream)
}
