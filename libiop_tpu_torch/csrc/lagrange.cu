// K25: the Lagrange basis of a domain H at a point alpha,
//   out[k] = L_k(alpha) = Z_H(alpha) / (Z_H'(h_k) (alpha - h_k)),
// and the one-hot vector (1 where h_k = alpha, 0 elsewhere) when alpha is in
// H.
//
// Replaces the JAX reference's lagrange_coefficients_any
// (libiop_tpu/algebra/generic.py:320-344) and lagrange_coefficients
// (libiop_tpu/algebra/poly.py:279-301): a subtraction pass, the products by
// Z', the field's elementwise inverse (Fermat a^(p-2) over a prime field,
// Itoh-Tsujii over GF(2^k)), a product by Z_H(alpha), and a select of the
// one-hot vector: an exponentiation an element (some 270 dependent products
// over edwards_Fr).
//
// Written as out[k] = zeta * w_k * (alpha - h_k)^-1.  Over a multiplicative
// coset (shift s, generator g, order h), Z_H'(h_k) = c g^-k with
// c = h s^(h-1), so w_k = g^k (the coset's memoized generator_powers table,
// built by K11) and zeta = Z_H(alpha) c^-1.  Over an affine subspace Z_H' is
// the constant eps, so w_k = 1 (no table) and zeta = Z_H(alpha) eps^-1.
// alpha and zeta are read from a device buffer (2 elements, alpha first), so
// a caller whose alpha lives on the device never syncs with the host.
//
// Membership: c and eps are not zero, so zeta = 0 exactly when alpha is in
// H.  Every block then writes one where alpha - h_k = 0 and zero elsewhere
// and skips its inversion: the reference's where(any(member), onehot,
// coeffs) without a second pass or a host check.
//
// Design (first, simple; one launch a call): Montgomery's trick per block,
// as K22 (csrc/bivariate.cu), with the shared scan and one inversion a
// block of csrc/block_inverse.cuh.  A block of kThreads threads owns
// kThreads * kPer consecutive elements; thread t takes elements t,
// t + kThreads, ...  Zeta scales the block's inverse once, so each element
// costs a product into the prefix, one for its inverse, one by w_k and one
// to step the running inverse: four products (three over a subspace), two
// subtractions, and three elements of memory traffic (h_k, w_k, out).
//
// Instantiated for W = 6 and 8 over a prime field (csrc/field.cuh, (2W, n)
// 16-bit limbs, Montgomery form in and out: the reference's limbs) and
// W = 2, 4, 6 and 8 over GF(2^k) (csrc/gf2k.cuh, (W, n) canonical words),
// through one kernel template on a field policy.
//
// Bound on the H100: integer instructions (four Montgomery products an
// element against three elements of memory traffic), ahead of memory; the
// serial inversion of each block is latency the other resident blocks
// hide.
#include <cuda_runtime.h>

#include "block_inverse.cuh"

namespace {

using binv::is_zero;

constexpr int kThreads = 128;
constexpr int kPer = 16;
constexpr size_t kBlockElems = (size_t)kThreads * kPer;

// hs: the elements h_k of H; ws: g^k, or null for w_k = 1; scal: (L, 2)
// with alpha at index 0 and zeta at index 1
template <int W, class Ops>
__global__ void lagrange_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ hs,
                                const uint32_t* __restrict__ ws,
                                const uint32_t* __restrict__ scal, size_t n,
                                Ops ops) {
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kBlockElems + t;
  uint32_t alpha[W], zeta[W], h[W], den[W];
  ops.load(alpha, scal, 2, 0);
  ops.load(zeta, scal, 2, 1);

  if (is_zero<W>(zeta)) {  // alpha in H: the one-hot vector
    uint32_t zero[W];
    fp::set_zero<W>(zero);
#pragma unroll 1
    for (int k = 0; k < kPer; ++k) {
      const size_t e = base + (size_t)k * kThreads;
      if (e >= n) break;
      ops.load(h, hs, n, e);
      ops.sub(den, alpha, h);
      ops.store(out, n, e, is_zero<W>(den) ? ops.one : zero);
    }
    return;  // zeta is the same for every thread: the whole block returns
  }

  // 1. den = alpha - h (never 0 here) and the exclusive prefix products
  uint32_t prefix[kPer][W];
  uint32_t run[W];
  fp::copy<W>(run, ops.one);
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const size_t e = base + (size_t)k * kThreads;
    fp::copy<W>(prefix[k], run);
    if (e < n) {
      ops.load(h, hs, n, e);
      ops.sub(den, alpha, h);
      ops.mul(run, run, den);
    }
  }

  // 2-3. the block's scans and its one inversion, scaled by zeta
  uint32_t inv[W];
  binv::thread_inverse<W, kThreads>(inv, run, zeta, ops);

  // 4. this thread's elements backwards: zeta den^-1 = inv * prefix_k
#pragma unroll 1
  for (int k = kPer - 1; k >= 0; --k) {
    const size_t e = base + (size_t)k * kThreads;
    if (e >= n) continue;
    uint32_t r[W];
    ops.load(h, hs, n, e);
    ops.sub(den, alpha, h);
    ops.mul(r, inv, prefix[k]);
    if (ws != nullptr) {
      uint32_t w[W];
      ops.load(w, ws, n, e);
      ops.mul(r, r, w);
    }
    ops.mul(inv, inv, den);
    ops.store(out, n, e, r);
  }
}

template <int W, class Ops>
int run(void* out, const void* hs, const void* ws, const void* scal,
        long long n, const Ops& ops, void* stream) {
  if (n > 0) {
    const size_t blocks = ((size_t)n + kBlockElems - 1) / kBlockElems;
    lagrange_kernel<W, Ops><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)hs, (const uint32_t*)ws,
        (const uint32_t*)scal, (size_t)n, ops);
  }
  return (int)cudaGetLastError();
}

template <int W>
int launch_prime(void* out, const void* hs, const void* ws, const void* scal,
                 long long n, const uint32_t* one, const uint32_t* field,
                 void* stream) {
  return run<W>(out, hs, ws, scal, n, binv::prime_ops<W>(field, one),
                stream);
}

template <int W>
int launch_binary(void* out, const void* hs, const void* ws, const void* scal,
                  long long n, const uint32_t* taps, void* stream) {
  return run<W>(out, hs, ws, scal, n, binv::binary_ops<W>(taps), stream);
}

}  // namespace

// out, hs, ws: (2W, n) Montgomery limbs (ws may be null: w_k = 1); scal:
// (2W, 2) limbs of alpha and zeta on the device; one: W words of R mod p;
// field: p and n0 (PrimeField.kernel_params())
extern "C" int lagrange_launch(void* out, const void* hs, const void* ws,
                               const void* scal, long long n,
                               const uint32_t* one, int words,
                               const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch_prime, out, hs, ws, scal, n, one, field,
                    stream)
}

// out, hs, ws: (W, n) words of GF(2^(32W)) (ws may be null); scal: (W, 2)
// words of alpha and zeta; taps: the pentanomial's four low exponents
// (BinaryField.kernel_params())
extern "C" int lagrange_gf2_launch(void* out, const void* hs, const void* ws,
                                   const void* scal, long long n, int words,
                                   const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch_binary, out, hs, ws, scal, n, taps, stream)
}
