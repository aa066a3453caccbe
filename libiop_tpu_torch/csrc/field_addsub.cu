// K5: batched modular add, sub and neg: out = a + b, a - b or -a mod p.
//
// Replaces the JAX reference's PrimeField.add / sub / neg
// (libiop_tpu/fields/prime.py:236, 242, 256, with _carry_canonicalize:197 and
// _cond_sub_p:211): a carry or borrow chain over L uint32 limb rows and a
// conditional subtraction of p, fused by XLA.  The port's plain version
// (fields/limbs.py add_plain / sub_plain) is about 100 small torch launches
// per call; this is one.
//
// Design (first, simple): one thread per output element, operands read
// through K1's index map (element (i / div) % mod of a contiguous (2W, n_op)
// array: equal shapes, a broadcast scalar, row or column).  The thread
// repacks 2W 16-bit limbs into W 32-bit limbs, runs the W-limb carry chain
// and the conditional subtraction of p (field.cuh) and writes 2W limbs back.
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: memory.  Each element moves 3 x 8W bytes (limbs stored
// one per int32) against ~4W 32-bit integer instructions.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum : int { kAdd = 0, kSub = 1, kNeg = 2 };

template <int W>
__global__ void field_addsub_kernel(uint32_t* __restrict__ out,
                                    const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b, size_t n,
                                    size_t a_div, size_t a_mod, size_t b_div,
                                    size_t b_mod, int op, fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[W], y[W];
  fp::load<W>(x, a, a_mod, (i / a_div) % a_mod);
  if (op == kNeg) {
    uint32_t zero[W];
    fp::set_zero<W>(zero);
    fp::sub_mod<W>(y, zero, x, P);
  } else {
    fp::load<W>(y, b, b_mod, (i / b_div) % b_mod);
    if (op == kAdd)
      fp::add_mod<W>(y, x, y, P);
    else
      fp::sub_mod<W>(y, x, y, P);
  }
  fp::store<W>(out, n, i, y);
}

template <int W>
int launch(void* out, const void* a, const void* b, long long n,
           long long a_div, long long a_mod, long long b_div, long long b_mod,
           int op, const uint32_t* field, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    field_addsub_kernel<W><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (size_t)n,
        (size_t)a_div, (size_t)a_mod, (size_t)b_div, (size_t)b_mod, op,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int field_addsub_launch(void* out, const void* a, const void* b,
                                   long long n, long long a_div,
                                   long long a_mod, long long b_div,
                                   long long b_mod, int op, int words,
                                   const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, a, b, n, a_div, a_mod, b_div, b_mod,
                    op, field, stream)
}
