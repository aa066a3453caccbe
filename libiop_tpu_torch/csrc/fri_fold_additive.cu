// K19: one additive FRI fold of a natural-order codeword over an affine
// subspace of GF(2^k).
//
// Replaces the JAX reference's fold_codeword_additive
// (libiop_tpu/protocols/fri.py:240).  The cosets of the localizer subspace
// V (the first eta basis vectors) are contiguous: coset j holds positions
// j*c .. j*c + c - 1, c = 2^eta.  At the challenge x the folded value is the
// coset's Lagrange interpolation, eps^-1 (Z_V(x) + Z_V(shift_j)) *
// sum_e f(e) / (x - e) (eps the linear coefficient of Z_V, Z_V(shift_j) the
// coset's constant offset), or f(e) exactly where x is the coset element e.
//
// Design: Montgomery's trick over blocks of 2,048 elements, as the
// reference inverts the whole codeword in one batch (fri.py:243-246).  A
// block of kThreads threads owns kThreads * kPer consecutive positions
// (cosets never straddle blocks: c <= 2,048); thread t takes positions
// t, t + kThreads, ... (coalesced loads).
//  1. Each thread forms D = x - e = x ^ e for its positions (e the
//     domain's memoized elements), keeps the exclusive prefix product
//     before each in shared memory and its running product; a zero D (x a
//     domain element) or a position past N enters the product as 1.
//  2-3. The block scans the threads' products and inverts the block's
//     product once (csrc/block_inverse.cuh, BinaryOps: Itoh-Tsujii).
//  4. Walking its positions backwards, D^-1 = inv * prefix, inv *= D, and
//     the term f(e) D^-1 replaces the prefix in shared memory; a zero D
//     leaves f(e) itself and marks its coset.
//  5. A thread a coset XORs its c terms and scales by eps^-1 (Z_V(x) ^
//     offset_j) (the offsets table memoized per domain), or takes the
//     marked f(e) where x is in the coset.  x, Z_V(x) and eps^-1 are
//     launch parameters.
// Three products an element for the inversion and one for the term, two a
// coset, one inversion a block; the first design inverted every element by
// its own Itoh-Tsujii chain (k - 1 squarings and ~13 products).
//
// Bound on the H100: integer instructions (four products an element
// against three elements of memory traffic); the serial inversion of each
// block is latency the other resident blocks hide.
#include <cuda_runtime.h>

#include "block_inverse.cuh"

namespace {

using binv::is_zero;

constexpr int kThreads = 128;
constexpr int kPer = 16;
constexpr int kBlockElems = kThreads * kPer;

template <int W>
struct FoldParams {
  uint32_t x[W];
  uint32_t zv_x[W];
  uint32_t eps_inv[W];
  binv::BinaryOps<W> ops;
};

template <int W>
__global__ void __launch_bounds__(kThreads)
    fri_fold_additive_kernel(uint32_t* __restrict__ out,
                             const uint32_t* __restrict__ v,
                             const uint32_t* __restrict__ elems,
                             const uint32_t* __restrict__ offs, size_t N,
                             int c, const __grid_constant__ FoldParams<W> P) {
  // (W, kBlockElems): the prefix products, then the terms
  extern __shared__ uint32_t sm[];
  __shared__ unsigned char member[kBlockElems];
  const auto& ops = P.ops;
  const int t = threadIdx.x;
  const size_t first = (size_t)blockIdx.x * kBlockElems;

  // 1. D = x ^ e and the exclusive prefix products of the thread's Ds
  uint32_t run[W], d[W];
  fp::copy<W>(run, ops.one);
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const int l = t + k * kThreads;
    const size_t e = first + l;
#pragma unroll
    for (int w = 0; w < W; ++w) sm[w * kBlockElems + l] = run[w];
    if (e < N) {
      gf::load<W>(d, elems, N, e);
      gf::add<W>(d, d, P.x);
      if (!is_zero<W>(d)) ops.mul(run, run, d);
    }
  }

  // 2-3. the block's scans and its one inversion (csrc/block_inverse.cuh)
  uint32_t inv[W];
  binv::thread_inverse<W, kThreads>(inv, run, ops.one, ops);

  // 4. the thread's positions backwards: the terms f(e) D^-1
#pragma unroll 1
  for (int k = kPer - 1; k >= 0; --k) {
    const int l = t + k * kThreads;
    const size_t e = first + l;
    if (e >= N) continue;
    uint32_t f[W], r[W];
    gf::load<W>(d, elems, N, e);
    gf::add<W>(d, d, P.x);
    gf::load<W>(f, v, N, e);
    if (is_zero<W>(d)) {
      member[l] = 1;
      fp::copy<W>(r, f);
    } else {
      member[l] = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) r[w] = sm[w * kBlockElems + l];
      ops.mul(r, inv, r);
      ops.mul(inv, inv, d);
      ops.mul(r, r, f);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) sm[w * kBlockElems + l] = r[w];
  }
  __syncthreads();

  // 5. a thread a coset
  const size_t nc = N / c;
  for (int jl = t; jl < kBlockElems / c; jl += kThreads) {
    const size_t j = first / c + jl;
    if (j >= nc) break;
    uint32_t acc[W], sel[W], term[W];
    gf::set_zero<W>(acc);
    gf::set_zero<W>(sel);
    bool has = false;
    for (int k = 0; k < c; ++k) {
      const int l = jl * c + k;
#pragma unroll
      for (int w = 0; w < W; ++w) term[w] = sm[w * kBlockElems + l];
      if (member[l]) {
        has = true;
        gf::add<W>(sel, sel, term);
      } else {
        gf::add<W>(acc, acc, term);
      }
    }
    if (!has) {
      gf::load<W>(term, offs, nc, j);
      gf::add<W>(term, term, P.zv_x);
      ops.mul(term, term, P.eps_inv);
      ops.mul(sel, acc, term);
    }
    gf::store<W>(out, nc, j, sel);
  }
}

template <int W>
int launch(void* out, const void* v, const void* elems, const void* offs,
           long long N, int c, const uint32_t* scalars, const uint32_t* taps,
           void* stream) {
  if (c < 1 || c > kBlockElems || N % c) return (int)cudaErrorInvalidValue;
  FoldParams<W> P;
  for (int w = 0; w < W; ++w) {
    P.x[w] = scalars[w];
    P.zv_x[w] = scalars[W + w];
    P.eps_inv[w] = scalars[2 * W + w];
  }
  P.ops = binv::binary_ops<W>(taps);
  const size_t smem = (size_t)4 * W * kBlockElems;
  const int err = (int)cudaFuncSetAttribute(
      fri_fold_additive_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  if (N > 0)
    fri_fold_additive_kernel<W>
        <<<(unsigned)((N + kBlockElems - 1) / kBlockElems), kThreads, smem,
           (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)v,
                                   (const uint32_t*)elems,
                                   (const uint32_t*)offs, (size_t)N, c, P);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (W, N/c); v, elems: (W, N); offs: (W, N/c); scalars: x, Z_V(x),
// eps^-1 (W words each); c <= 2,048
extern "C" int fri_fold_additive_launch(void* out, const void* v,
                                        const void* elems, const void* offs,
                                        long long N, int c, int words,
                                        const uint32_t* scalars,
                                        const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch, out, v, elems, offs, N, c, scalars, taps,
                    stream)
}
