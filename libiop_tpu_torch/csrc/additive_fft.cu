// K17: the Gao-Mateer additive FFT and its inverse over an affine subspace
// of GF(2^k), natural (subset-sum) order in and out.
//
// Replaces the JAX reference's _additive_fft_impl / _additive_ifft_impl
// (libiop_tpu/algebra/subspace.py:172 and :220), whose levels XLA fused
// over the (W, n) word tensor.  Per level j of m = log2 n (forward): twist
// element i by tw_j[i >> j]; radix conversion, XOR butterflies x2 ^= x3,
// x1 ^= x2 over groups of 4 at strides n/4 down to 2^j (index bits b and
// b + 1 for stride 2^b); then a bit reversal and m unwind levels
// lo = x0 ^ x1 * sums_j[c], hi = x1 ^ lo over bit j of the output index.
// The inverse runs the same steps backwards with the inverse twist powers.
//
// Design: passes in shared memory.  A pass is one launch of pass_kernel:
// each block loads the 2^B elements whose index bits outside the pass's
// inside bits (a low run [0, low) and a window [lo, lo + win)) equal its
// block number, runs the pass's steps on them in shared memory with a
// barrier after each, and stores them.  Levels j >= j0 act on residue
// classes mod 2^j0 alone, so one pass runs them all and the first unwind
// levels with them; each earlier level takes a column pass and a tile
// pass; the last unwind levels run in the output order, reading through
// the bit reversal (kernels/additive_fft.py explains the plan).  The plan
// comes from Python (additive_fft_plan) as a list of passes; this launcher
// runs them in order, 16 launches for 2^16 and 22 for 2^20, where the
// first design launched 153 and 231 kernels (one a twist level, radix
// stride and unwind level, and the bit reversal).  A batch of R
// transforms of one domain ((W, R, n) words, as Ligero encodes its rows)
// shares the tables and every launch: R times the blocks.  Shared memory
// is words first, (W, 2^B); local element l sits at slot l ^ (its top five
// bits), so that runs of consecutive and of bit-reversed local indices hit
// distinct banks.  Passes whose load and store orders agree run in place;
// the one that reverses writes to the output buffer.
//
// Bound on the H100: integer instructions.  1.5 m n products (n twists and
// n/2 unwinds a level, gf2k.cuh's Horner product, ~2,000 instructions at
// W = 6) against a few dozen reads and writes of the array, most of them
// from L2.  The twist and unwind multipliers are shared by many elements;
// a comb table of them would cut the products (later work).
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxOps = 128;  // kernels/additive_fft.py MAX_OPS
constexpr int kTwist = 0, kRadix = 1;  // else unwind

struct PassDesc {
  int m, low, lo, win, space_o, load_rev, store_rev, inverse, nops;
  uint16_t ops[kMaxOps];  // kind << 8 | argument
};

__device__ __forceinline__ size_t brev(size_t x, int bits) {
  return bits ? (size_t)(__brevll((unsigned long long)x) >> (64 - bits)) : 0;
}

__device__ __forceinline__ unsigned insert_zero(unsigned u, int pos) {
  return (u & ((1u << pos) - 1)) | ((u >> pos) << (pos + 1));
}

// the shared-memory slot of local element l of a block of 2^B
__device__ __forceinline__ unsigned slot(unsigned l, int B) {
  return l ^ ((l >> (B > 10 ? B - 5 : 5)) & 31u);
}

template <int W>
__device__ __forceinline__ void sm_load(uint32_t x[W], const uint32_t* sm,
                                        unsigned size, unsigned s) {
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = sm[w * size + s];
}

template <int W>
__device__ __forceinline__ void sm_store(uint32_t* sm, unsigned size,
                                         unsigned s, const uint32_t x[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) sm[w * size + s] = x[w];
}

// One pass over N = R n elements.  src and dst may be the same array: a
// block loads every element it stores before it stores any, and no other
// block touches them.
template <int W>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(uint32_t* dst, const uint32_t* src,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ sums, size_t N,
                const __grid_constant__ PassDesc P, const gf::Taps T) {
  extern __shared__ uint32_t sm[];
  const int B = P.low + P.win;
  const unsigned size = 1u << B;
  const size_t n = (size_t)1 << P.m;
  const int gbits = P.m - B;
  const size_t g = blockIdx.x & (((size_t)1 << gbits) - 1);
  const size_t row = (size_t)blockIdx.x >> gbits;
  const int gap = P.lo - P.low;
  const size_t base = ((g & (((size_t)1 << gap) - 1)) << P.low) |
                      ((g >> gap) << (P.lo + P.win));
  const unsigned low_mask = (1u << P.low) - 1;
  auto index = [&](unsigned l) -> size_t {
    return base | (l & low_mask) | ((size_t)(l >> P.low) << P.lo);
  };
  auto local_bit = [&](int bit) { return bit < P.low ? bit : P.low + bit - P.lo; };

  // load: where the global order is reversed, walk the local indices
  // bit-reversed too, so that neighbouring threads read neighbours
  for (unsigned q = threadIdx.x; q < size; q += blockDim.x) {
    const unsigned l = P.load_rev ? (unsigned)brev(q, B) : q;
    const size_t p = index(l);
    const size_t at = row * n + (P.load_rev ? brev(p, P.m) : p);
    const unsigned s = slot(l, B);
#pragma unroll
    for (int w = 0; w < W; ++w) sm[w * size + s] = src[w * N + at];
  }
  __syncthreads();

  for (int k = 0; k < P.nops; ++k) {
    const int kind = P.ops[k] >> 8, a = P.ops[k] & 255;
    if (kind == kTwist) {
      const size_t off = 2 * n - 2 * (n >> a), tw_len = 2 * n - 2;
      for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
        uint32_t x[W], y[W];
        const unsigned s = slot(l, B);
        sm_load<W>(x, sm, size, s);
        gf::load<W>(y, tw, tw_len, off + (index(l) >> a));
        gf::mul<W>(x, x, y, T);
        sm_store<W>(sm, size, s, x);
      }
    } else if (kind == kRadix) {
      const int s1 = local_bit(a), s2 = local_bit(a + 1);
      for (unsigned u = threadIdx.x; u < size / 4; u += blockDim.x) {
        const unsigned l0 = insert_zero(insert_zero(u, s1), s2);
        const unsigned i1 = slot(l0 | (1u << s1), B),
                       i2 = slot(l0 | (1u << s2), B),
                       i3 = slot(l0 | (1u << s1) | (1u << s2), B);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t* r = sm + w * size;
          const uint32_t x1 = r[i1], x2 = r[i2], x3 = r[i3];
          if (P.inverse) {
            r[i1] = x1 ^ x2;
            r[i2] = x2 ^ x3;
          } else {
            r[i2] = x2 ^ x3;
            r[i1] = x1 ^ x2 ^ x3;
          }
        }
      }
    } else {
      // unwind level a: pairs over bit a of the output index o, which is
      // bit m-1-a of the radix order; the constant is sums_a[o mod 2^a]
      const int sb = local_bit(P.space_o ? a : P.m - 1 - a);
      const size_t off = ((size_t)1 << a) - 1, cmask = off;
      for (unsigned u = threadIdx.x; u < size / 2; u += blockDim.x) {
        const unsigned l0 = insert_zero(u, sb), l1 = l0 | (1u << sb);
        const size_t p0 = index(l0);
        const size_t o0 = P.space_o ? p0 : brev(p0, P.m);
        uint32_t x0[W], x1[W], z[W], t[W];
        const unsigned s0 = slot(l0, B), s1 = slot(l1, B);
        sm_load<W>(x0, sm, size, s0);
        sm_load<W>(x1, sm, size, s1);
        gf::load<W>(z, sums, n - 1, off + (o0 & cmask));
        if (P.inverse) {
          gf::add<W>(x1, x1, x0);
          gf::mul<W>(t, x1, z, T);
          gf::add<W>(x0, x0, t);
        } else {
          gf::mul<W>(t, x1, z, T);
          gf::add<W>(x0, x0, t);
          gf::add<W>(x1, x1, x0);
        }
        sm_store<W>(sm, size, s0, x0);
        sm_store<W>(sm, size, s1, x1);
      }
    }
    __syncthreads();
  }

  for (unsigned q = threadIdx.x; q < size; q += blockDim.x) {
    const unsigned l = P.store_rev ? (unsigned)brev(q, B) : q;
    const size_t p = index(l);
    const size_t at = row * n + (P.store_rev ? brev(p, P.m) : p);
    const unsigned s = slot(l, B);
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w * N + at] = sm[w * size + s];
  }
}

template <int W>
int launch(void* out, void* tmp, const void* in, const void* tw,
           const void* sums, int m, long long R, int inverse, const int* plan,
           int passes, const uint32_t* taps, void* stream) {
  const gf::Taps T = gf::taps_from(taps);
  const size_t N = (size_t)R << m;
  auto st = (cudaStream_t)stream;
  // read the plan once to check it and size shared memory for its largest
  // block (kernels/additive_fft.py block_bits chooses the sizes; the card
  // refuses the attribute when they exceed what a block may take)
  int max_bits = 0;
  const int* q = plan;
  for (int k = 0; k < passes; ++k) {
    const int low = q[1], lo = q[2], win = q[3], nops = q[6], B = low + win;
    if (nops > kMaxOps || B > m || lo < low || lo + win > m)
      return (int)cudaErrorInvalidValue;
    if (B > max_bits) max_bits = B;
    q += 7 + nops;
  }
  const int err = (int)cudaFuncSetAttribute(
      pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * W << max_bits);
  if (err) return err;
  const uint32_t* src = (const uint32_t*)in;
  bool reversed = false;
  q = plan;
  for (int k = 0; k < passes; ++k) {
    PassDesc P;
    P.m = m;
    P.space_o = q[0];
    P.low = q[1];
    P.lo = q[2];
    P.win = q[3];
    P.load_rev = q[4];
    P.store_rev = q[5];
    P.nops = q[6];
    P.inverse = inverse;
    const int B = P.low + P.win;
    for (int o = 0; o < P.nops; ++o) P.ops[o] = (uint16_t)q[7 + o];
    q += 7 + P.nops;
    // the pass that reverses the order, and every pass after it, writes
    // the output; the passes before it the scratch buffer
    if (P.load_rev != P.store_rev) reversed = true;
    uint32_t* dst = (uint32_t*)(reversed ? out : tmp);
    const size_t smem = (size_t)4 * W << B;
    const unsigned threads = (1u << B) < kThreads ? (1u << B) : kThreads;
    const size_t blocks = (size_t)R << (m - B);
    pass_kernel<W><<<(unsigned)blocks, threads, smem, st>>>(
        dst, src, (const uint32_t*)tw, (const uint32_t*)sums, N, P, T);
    src = dst;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out: (W, R, n) output; tmp: (W, R, n) scratch (out itself where the first
// pass reverses); in: (W, R, n) input, read only; tw: (W, 2n - 2) flat
// twist powers (the inverse powers when inverse); sums: (W, n - 1) flat
// subset sums; plan: the passes (kernels/additive_fft.py _encoded), the
// IFFT's when inverse
extern "C" int additive_fft_launch(void* out, void* tmp, const void* in,
                                   const void* tw, const void* sums, int m,
                                   long long R, int inverse, int words,
                                   const int* plan, int passes,
                                   const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch, out, tmp, in, tw, sums, m, R, inverse,
                    plan, passes, taps, stream)
}
