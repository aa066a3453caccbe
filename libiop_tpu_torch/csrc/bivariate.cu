// K22: the evaluations of the bivariate Lagrange polynomial of a domain S at
// a fixed x over a domain L,
//   out[i] = (Z_S(x) - Z_S(y_i)) * (x - y_i)^-1   for y_i the i-th element of L,
// with (x - y_i)^-1 taken as 0 where it is 0, and out[diag] = Z_S'(x) where
// x is the diag-th element of L (diag = -1 when x is not in L).
//
// Replaces the JAX reference's BivariateLagrange.evaluations_over
// (libiop_tpu/algebra/bivariate.py:72-92): a subtraction pass, the field's
// elementwise inverse (Fermat a^(p-2) for a prime field, the Itoh-Tsujii
// chain over GF(2^k)), a product, and a scatter of the diagonal, which XLA
// fused into one pass of some 270 dependent products an element.
//
// Inputs: y and Z_S(y) over L are the port's memoized device tables
// (L.elements and vanishing_evals_over_any, built by K11 and the subset-sum
// doubling); x, Z_S(x) and Z_S'(x) are host ints passed as words.
//
// Design (first, simple; one launch a call): Montgomery's trick per block,
// as K20 (csrc/batch_inv.cu).  A block of kThreads threads owns kThreads *
// kPer consecutive elements; thread t takes elements t, t + kThreads, ...
//  1. Each thread walks its elements, forms den = x - y, keeps the exclusive
//     prefix product before each one (local memory) and its running product;
//     a zero den (or an element past n) enters the product as 1.
//  2. The block scans the threads' products in shared memory (Hillis-Steele,
//     both ways) into an exclusive prefix and suffix per thread.
//  3. Thread 0 inverts the block's product: one inversion a block (Fermat
//     over a prime field, Itoh-Tsujii over GF(2^k)).
//  4. Each thread's product inverse is block_inv * prefix * suffix; walking
//     its elements backwards, den^-1 = inv * prefix_k, inv *= den, and
//     out = den^-1 * (Z_S(x) - Z_S(y)), 0 for a zero den, Z_S'(x) at diag.
// About 4 products and 2 subtractions an element, plus the scans and one
// inversion a block.  A prime field stays in Montgomery form throughout, so
// the output is the Montgomery form of the reference's value (the same
// limbs); GF(2^k) words are canonical.
//
// Instantiated for W = 6 and 8 over a prime field (csrc/field.cuh, (2W, n)
// 16-bit limbs) and W = 2, 4, 6 and 8 over GF(2^k) (csrc/gf2k.cuh, (W, n)
// words), through one kernel template on a field policy.
//
// Bound on the H100: integer instructions (four products an element against
// three elements of memory traffic), ahead of memory; the serial inversion
// of each block is latency the other resident blocks hide.
#include <cuda_runtime.h>

#include "block_inverse.cuh"

namespace {

using binv::is_zero;

constexpr int kThreads = 128;
constexpr int kPer = 16;
constexpr size_t kBlockElems = (size_t)kThreads * kPer;

template <int W>
struct Scalars {
  uint32_t x[W];    // the fixed point
  uint32_t zx[W];   // Z_S(x)
  uint32_t zpx[W];  // Z_S'(x)
};

template <int W, class Ops>
__global__ void bivariate_kernel(uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ ys,
                                 const uint32_t* __restrict__ zy, size_t n,
                                 long long diag, Scalars<W> S, Ops ops) {
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kBlockElems + t;

  // 1. den = x - y and the exclusive prefix products of the thread's dens
  uint32_t prefix[kPer][W];
  uint32_t run[W], y[W], den[W];
  fp::copy<W>(run, ops.one);
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const size_t e = base + (size_t)k * kThreads;
    fp::copy<W>(prefix[k], run);
    if (e < n) {
      ops.load(y, ys, n, e);
      ops.sub(den, S.x, y);
      if (!is_zero<W>(den)) ops.mul(run, run, den);
    }
  }

  // 2-3. the block's scans and its one inversion (csrc/block_inverse.cuh)
  uint32_t inv[W];
  binv::thread_inverse<W, kThreads>(inv, run, ops.one, ops);

  // 4. this thread's elements backwards
#pragma unroll 1
  for (int k = kPer - 1; k >= 0; --k) {
    const size_t e = base + (size_t)k * kThreads;
    if (e >= n) continue;
    uint32_t r[W];
    ops.load(y, ys, n, e);
    ops.sub(den, S.x, y);
    if ((long long)e == diag) {
      fp::copy<W>(r, S.zpx);
    } else if (is_zero<W>(den)) {
      fp::set_zero<W>(r);
    } else {
      uint32_t num[W];
      ops.mul(r, inv, prefix[k]);
      ops.load(num, zy, n, e);
      ops.sub(num, S.zx, num);
      ops.mul(r, r, num);
    }
    if (!is_zero<W>(den)) ops.mul(inv, inv, den);
    ops.store(out, n, e, r);
  }
}

template <int W, class Ops>
int run(void* out, const void* ys, const void* zy, long long n,
        long long diag, const uint32_t* scalars, const Ops& ops,
        void* stream) {
  Scalars<W> S;
  for (int j = 0; j < W; ++j) {
    S.x[j] = scalars[j];
    S.zx[j] = scalars[W + j];
    S.zpx[j] = scalars[2 * W + j];
  }
  if (n > 0) {
    const size_t blocks = ((size_t)n + kBlockElems - 1) / kBlockElems;
    bivariate_kernel<W, Ops><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)ys, (const uint32_t*)zy, (size_t)n,
        diag, S, ops);
  }
  return (int)cudaGetLastError();
}

template <int W>
int launch_prime(void* out, const void* ys, const void* zy, long long n,
                 long long diag, const uint32_t* scalars,
                 const uint32_t* one, const uint32_t* field, void* stream) {
  return run<W>(out, ys, zy, n, diag, scalars,
                binv::prime_ops<W>(field, one), stream);
}

template <int W>
int launch_binary(void* out, const void* ys, const void* zy, long long n,
                  long long diag, const uint32_t* scalars,
                  const uint32_t* taps, void* stream) {
  return run<W>(out, ys, zy, n, diag, scalars, binv::binary_ops<W>(taps),
                stream);
}

}  // namespace

// out, ys, zy: (2W, n) Montgomery limbs; scalars: x, Z_S(x), Z_S'(x) as W
// 32-bit Montgomery words each; diag: the index of x in L or -1; one: W
// words of R mod p; field: p and n0 (PrimeField.kernel_params())
extern "C" int bivariate_launch(void* out, const void* ys, const void* zy,
                                long long n, long long diag,
                                const uint32_t* scalars, const uint32_t* one,
                                int words, const uint32_t* field,
                                void* stream) {
  FP_DISPATCH_WORDS(words, launch_prime, out, ys, zy, n, diag, scalars, one,
                    field, stream)
}

// out, ys, zy: (W, n) words of GF(2^(32W)); scalars: x, Z_S(x), Z_S'(x) as
// W words each; diag as above; taps: the pentanomial's four low exponents
// (BinaryField.kernel_params())
extern "C" int bivariate_gf2_launch(void* out, const void* ys, const void* zy,
                                    long long n, long long diag,
                                    const uint32_t* scalars, int words,
                                    const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch_binary, out, ys, zy, n, diag, scalars,
                    taps, stream)
}
