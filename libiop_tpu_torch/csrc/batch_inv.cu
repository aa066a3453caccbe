// K20: batched inverse with the product by a numerator fused in,
// out = c * a^-1 elementwise, with 0^-1 taken as 0 (c = 1 when absent).
//
// Replaces the JAX reference's PrimeField.inv (libiop_tpu/fields/prime.py:447,
// Fermat a^(p-2) through pow_static at :428, one square-and-multiply chain
// of ~270 products an element that XLA fused) and batch_inverse_and_mul
// (:452, that chain then one product).  On the Fractal path these invert
// whole codewords: p_alpha over L (algebra/poly.py:247-260), the rational
// combination over K (protocols/common.py:148-153) and (f - v)/(x - beta)
// of the boundary constraint (common.py:45-53); the Aurora paths invert
// their memoized vanishing tables through it.
//
// Design (first, simple): Montgomery's trick per block.  A block of
// kThreads threads owns kThreads * kPer consecutive elements; thread t
// takes elements t, t + kThreads, ... (coalesced loads).
//  1. Each thread walks its kPer elements, keeping the exclusive prefix
//     product before each one (local memory) and its running product; a
//     zero (or an element past n) enters the product as 1.
//  2. The block scans the threads' products in shared memory
//     (Hillis-Steele, log2(kThreads) rounds each way) into an exclusive
//     prefix and an exclusive suffix per thread.
//  3. Thread 0 inverts the block's product by Fermat, x^(p-2) (square and
//     multiply, MSB first): one inversion a block.
//  4. Each thread's own product inverse is block_inv * prefix * suffix;
//     walking its elements backwards, a_k^-1 = inv * prefix_k, then
//     inv *= a_k, and out_k = c_k * a_k^-1 (or 0 for a zero a_k).
// About 3 products an element (4 with c), plus (2 log2(kThreads) + 2) / kPer
// for the scans and one Fermat chain a block.  All values stay in
// Montgomery form (x R), and (x R)^(p-2) through mont_mul is x^-1 R, so the
// result is the Montgomery form of the reference's value.
//
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: integer instructions (about 3-4 CIOS products, ~1,000
// instructions at W = 6, against 2-3 x 8W bytes an element), ahead of
// memory; the serial Fermat chain of each block (~270 dependent products)
// is latency the other resident blocks hide.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 16;
constexpr size_t kBlockElems = (size_t)kThreads * kPer;

template <int W>
struct Consts {
  uint32_t one[W];  // R mod p, the Montgomery form of 1
  uint32_t pm2[W];  // the exponent p - 2
};

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t x[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) acc |= x[j];
  return acc == 0;
}

template <int W>
__device__ void fermat_inverse(uint32_t r[W], const uint32_t x[W],
                               const Consts<W>& C, const fp::Params<W>& P) {
  uint32_t acc[W];
  fp::copy<W>(acc, C.one);
  bool started = false;
  for (int j = W - 1; j >= 0; --j) {
    for (int b = 31; b >= 0; --b) {
      if (started) fp::mont_mul<W>(acc, acc, acc, P);
      if ((C.pm2[j] >> b) & 1u) {
        fp::mont_mul<W>(acc, acc, x, P);
        started = true;
      }
    }
  }
  fp::copy<W>(r, acc);
}

template <int W>
__global__ void batch_inv_kernel(uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ c, size_t n,
                                 Consts<W> C, fp::Params<W> P) {
  __shared__ uint32_t pre[2][kThreads][W];
  __shared__ uint32_t suf[2][kThreads][W];
  __shared__ uint32_t block_inv[W];
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kBlockElems + t;

  // 1. exclusive prefix products of the thread's elements
  uint32_t prefix[kPer][W];
  uint32_t run[W], x[W];
  fp::copy<W>(run, C.one);
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const size_t e = base + (size_t)k * kThreads;
    fp::copy<W>(prefix[k], run);
    if (e < n) {
      fp::load<W>(x, a, n, e);
      if (!is_zero<W>(x)) fp::mont_mul<W>(run, run, x, P);
    }
  }

  // 2. inclusive scans of the threads' products, both ways
  fp::copy<W>(pre[0][t], run);
  fp::copy<W>(suf[0][t], run);
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < kThreads; d <<= 1) {
    uint32_t v[W], s[W];
    fp::copy<W>(v, pre[cur][t]);
    fp::copy<W>(s, suf[cur][t]);
    if (t >= d) fp::mont_mul<W>(v, v, pre[cur][t - d], P);
    if (t + d < kThreads) fp::mont_mul<W>(s, s, suf[cur][t + d], P);
    fp::copy<W>(pre[cur ^ 1][t], v);
    fp::copy<W>(suf[cur ^ 1][t], s);
    __syncthreads();
    cur ^= 1;
  }

  // 3. one Fermat inversion of the block's product
  if (t == 0) fermat_inverse<W>(block_inv, pre[cur][kThreads - 1], C, P);
  __syncthreads();

  // 4. this thread's inverse, then its elements backwards
  uint32_t inv[W];
  fp::copy<W>(inv, block_inv);
  if (t > 0) fp::mont_mul<W>(inv, inv, pre[cur][t - 1], P);
  if (t + 1 < kThreads) fp::mont_mul<W>(inv, inv, suf[cur][t + 1], P);
#pragma unroll 1
  for (int k = kPer - 1; k >= 0; --k) {
    const size_t e = base + (size_t)k * kThreads;
    if (e >= n) continue;
    uint32_t r[W];
    fp::load<W>(x, a, n, e);
    if (is_zero<W>(x)) {
      fp::set_zero<W>(r);
    } else {
      fp::mont_mul<W>(r, inv, prefix[k], P);
      fp::mont_mul<W>(inv, inv, x, P);
      if (c != nullptr) {
        uint32_t y[W];
        fp::load<W>(y, c, n, e);
        fp::mont_mul<W>(r, r, y, P);
      }
    }
    fp::store<W>(out, n, e, r);
  }
}

template <int W>
int launch(void* out, const void* a, const void* c, long long n,
           const uint32_t* one, const uint32_t* field, void* stream) {
  const fp::Params<W> P = fp::params_from<W>(field);
  Consts<W> C;
  uint64_t borrow = 2;
  for (int j = 0; j < W; ++j) {
    C.one[j] = one[j];
    const uint64_t v = (uint64_t)P.p[j] - borrow;
    C.pm2[j] = (uint32_t)v;
    borrow = (v >> 63) & 1u;
  }
  if (n > 0) {
    const size_t blocks = ((size_t)n + kBlockElems - 1) / kBlockElems;
    batch_inv_kernel<W><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)c, (size_t)n, C,
        P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out, a, c: (2W, n) limbs (c may be null: out = a^-1); one: W words of
// R mod p; field: p and n0 (PrimeField.kernel_params())
extern "C" int batch_inv_launch(void* out, const void* a, const void* c,
                                long long n, const uint32_t* one, int words,
                                const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, a, c, n, one, field, stream)
}
