// Montgomery's trick across a thread block, and the field policies it runs
// over: the part that K22 (bivariate.cu) and K25 (lagrange.cu) share.
//
// A block of kThreads threads owns kThreads * kPer consecutive elements;
// each thread multiplies its own denominators into a running product.
// thread_inverse then scans those products across the block (Hillis-Steele
// in shared memory, both ways), inverts the block's product once (thread 0:
// Fermat over a prime field, Itoh-Tsujii over GF(2^k)) and hands every
// thread scale * (its own product)^-1, from which the thread walks its
// elements backwards (den_k^-1 = inv * prefix_k, then inv *= den_k).
//
// The policies give one kernel template both layouts: PrimeOps<W> keeps a
// prime field in Montgomery form, (2W, n) 16-bit limbs (csrc/field.cuh);
// BinaryOps<W> is GF(2^(32W)), (W, n) words (csrc/gf2k.cuh).
#pragma once
#include "field.cuh"
#include "gf2k.cuh"

namespace binv {

// A prime field in Montgomery form, (2W, n) 16-bit limbs.
template <int W>
struct PrimeOps {
  fp::Params<W> P;
  uint32_t one[W];  // R mod p
  uint32_t pm2[W];  // the exponent p - 2

  __device__ void load(uint32_t x[W], const uint32_t* src, size_t n,
                       size_t e) const {
    fp::load<W>(x, src, n, e);
  }
  __device__ void store(uint32_t* dst, size_t n, size_t e,
                        const uint32_t x[W]) const {
    fp::store<W>(dst, n, e, x);
  }
  __device__ void mul(uint32_t r[W], const uint32_t a[W],
                      const uint32_t b[W]) const {
    fp::mont_mul<W>(r, a, b, P);
  }
  __device__ void sub(uint32_t r[W], const uint32_t a[W],
                      const uint32_t b[W]) const {
    fp::sub_mod<W>(r, a, b, P);
  }
  // x^(p-2) by square and multiply, MSB first
  __device__ void inv(uint32_t r[W], const uint32_t x[W]) const {
    uint32_t acc[W];
    fp::copy<W>(acc, one);
    bool started = false;
    for (int j = W - 1; j >= 0; --j) {
      for (int b = 31; b >= 0; --b) {
        if (started) fp::mont_mul<W>(acc, acc, acc, P);
        if ((pm2[j] >> b) & 1u) {
          fp::mont_mul<W>(acc, acc, x, P);
          started = true;
        }
      }
    }
    fp::copy<W>(r, acc);
  }
};

// The launch-side set-up of PrimeOps: p and n0 from PrimeField.
// kernel_params(), R mod p as W words, and p - 2.
template <int W>
PrimeOps<W> prime_ops(const uint32_t* field, const uint32_t* one) {
  PrimeOps<W> ops;
  ops.P = fp::params_from<W>(field);
  uint64_t borrow = 2;
  for (int j = 0; j < W; ++j) {
    ops.one[j] = one[j];
    const uint64_t v = (uint64_t)ops.P.p[j] - borrow;
    ops.pm2[j] = (uint32_t)v;
    borrow = (v >> 63) & 1u;
  }
  return ops;
}

// GF(2^k), k = 32 W, (W, n) words.
template <int W>
struct BinaryOps {
  gf::Taps T;
  uint32_t one[W];

  __device__ void load(uint32_t x[W], const uint32_t* src, size_t n,
                       size_t e) const {
    gf::load<W>(x, src, n, e);
  }
  __device__ void store(uint32_t* dst, size_t n, size_t e,
                        const uint32_t x[W]) const {
    gf::store<W>(dst, n, e, x);
  }
  __device__ void mul(uint32_t r[W], const uint32_t a[W],
                      const uint32_t b[W]) const {
    gf::mul<W>(r, a, b, T);
  }
  __device__ void sub(uint32_t r[W], const uint32_t a[W],
                      const uint32_t b[W]) const {
    gf::add<W>(r, a, b);
  }
  __device__ void inv(uint32_t r[W], const uint32_t x[W]) const {
    gf::inv<W>(r, x, T);
  }
};

// The launch-side set-up of BinaryOps: the taps of BinaryField.
// kernel_params().
template <int W>
BinaryOps<W> binary_ops(const uint32_t* taps) {
  BinaryOps<W> ops;
  ops.T = gf::taps_from(taps);
  for (int j = 0; j < W; ++j) ops.one[j] = j == 0 ? 1u : 0u;
  return ops;
}

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t x[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) acc |= x[j];
  return acc == 0;
}

// inv = scale * run^-1 for this thread's product run, with one inversion
// for the whole block.  Every thread of the block must call it (it
// synchronizes the block).
template <int W, int kThreads, class Ops>
__device__ void thread_inverse(uint32_t inv[W], const uint32_t run[W],
                               const uint32_t scale[W], const Ops& ops) {
  __shared__ uint32_t pre[2][kThreads][W];
  __shared__ uint32_t suf[2][kThreads][W];
  __shared__ uint32_t block_inv[W];
  const int t = threadIdx.x;

  // inclusive scans of the threads' products, both ways
  fp::copy<W>(pre[0][t], run);
  fp::copy<W>(suf[0][t], run);
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < kThreads; d <<= 1) {
    uint32_t v[W], s[W];
    fp::copy<W>(v, pre[cur][t]);
    fp::copy<W>(s, suf[cur][t]);
    if (t >= d) ops.mul(v, v, pre[cur][t - d]);
    if (t + d < kThreads) ops.mul(s, s, suf[cur][t + d]);
    fp::copy<W>(pre[cur ^ 1][t], v);
    fp::copy<W>(suf[cur ^ 1][t], s);
    __syncthreads();
    cur ^= 1;
  }

  // one inversion of the block's product, times the scale
  if (t == 0) {
    uint32_t r[W];
    ops.inv(r, pre[cur][kThreads - 1]);
    ops.mul(block_inv, r, scale);
  }
  __syncthreads();

  // this thread's share: the other threads' products times block_inv
  fp::copy<W>(inv, block_inv);
  if (t > 0) ops.mul(inv, inv, pre[cur][t - 1]);
  if (t + 1 < kThreads) ops.mul(inv, inv, suf[cur][t + 1]);
}

}  // namespace binv
