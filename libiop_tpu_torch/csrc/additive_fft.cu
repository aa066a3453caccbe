// K17: the Gao-Mateer additive FFT and its inverse over an affine subspace
// of GF(2^k), natural (subset-sum) order in and out.
//
// Replaces the JAX reference's _additive_fft_impl / _additive_ifft_impl
// (libiop_tpu/algebra/subspace.py:172 and :220), whose levels XLA fused
// over the (W, n) word tensor.  Per level j of m = log2 n (forward): twist
// row r of the (n >> j, 2^j) view by beta_j^r; radix conversion, XOR
// butterflies x2 ^= x3, x1 ^= x2 over groups of 4 at strides n/4 down to
// 2^j; then a bit reversal and m unwind levels lo = x0 ^ x1 * sums_j[c],
// hi = x1 ^ lo at stride 2^j.  The inverse runs the same steps backwards
// with the inverse twist powers.
//
// Design (first, simple): one launch per twist level, per radix stride,
// for the bit reversal and per unwind level, one thread per element,
// group of four or pair; the C launcher walks the levels itself (one ctypes
// call an FFT) and reports how many kernels it launched.  A batch of R
// transforms of one domain ((W, R, n) words, as Ligero encodes its rows)
// shares the tables and every launch: element i of row r is flat index
// r n + i of the R n elements, and the level steps act on i.  The tables are
// built on the card and memoized per domain by the caller: twist powers of
// every level in one flat (W, 2n - 2) table (level j at 2n - 2(n >> j)),
// subset sums in one flat (W, n - 1) table (level j at 2^j - 1).
//
// Bound on the H100: at these sizes the twists and unwinds are
// integer-instruction bound (n/2 + n products a level, gf2k.cuh), the XOR
// radix passes memory bound (~m^2/2 passes over the codeword); a shared
// memory tail over the last ~11 levels would cut both the passes and the
// launches (later work).
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

constexpr int kThreads = 128;

unsigned blocks_for(size_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// S[r n + i] *= tw[off + (i >> j)] over the N = R n elements
template <int W>
__global__ void twist_kernel(uint32_t* __restrict__ S,
                             const uint32_t* __restrict__ tw, size_t tw_len,
                             size_t off, size_t n, size_t N, int j,
                             gf::Taps T) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  uint32_t x[W], y[W];
  gf::load<W>(x, S, N, e);
  gf::load<W>(y, tw, tw_len, off + ((e % n) >> j));
  gf::mul<W>(x, x, y, T);
  gf::store<W>(S, N, e, x);
}

// groups of four at stride s: forward x2 ^= x3, x1 ^= x2; inverse
// x1 ^= x2, x2 ^= x3
template <int W>
__global__ void radix_kernel(uint32_t* __restrict__ S, size_t n, size_t N,
                             size_t s, int inverse) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N / 4) return;
  const size_t g = q % (n / 4);
  const size_t base = (q / (n / 4)) * n + (g / s) * 4 * s + g % s;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t* row = S + w * N + base;
    const uint32_t x1 = row[s], x2 = row[2 * s], x3 = row[3 * s];
    if (inverse) {
      row[s] = x1 ^ x2;
      row[2 * s] = x2 ^ x3;
    } else {
      row[2 * s] = x2 ^ x3;
      row[s] = x1 ^ x2 ^ x3;
    }
  }
}

__device__ __forceinline__ size_t bit_reverse(size_t i, int m) {
  return m ? (size_t)(__brevll((unsigned long long)i) >> (64 - m)) : 0;
}

template <int W>
__global__ void bitrev_kernel(uint32_t* __restrict__ dst,
                              const uint32_t* __restrict__ src, size_t n,
                              size_t N, int m) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const size_t r = e - e % n + bit_reverse(e % n, m);
#pragma unroll
  for (int w = 0; w < W; ++w) dst[w * N + e] = src[w * N + r];
}

// pairs (x0, x1) at stride s = 2^j with c the index inside the stride:
// forward lo = x0 ^ x1 * sums[c], hi = x1 ^ lo; inverse hi = x1 ^ x0,
// lo = x0 ^ hi * sums[c]
template <int W>
__global__ void unwind_kernel(uint32_t* __restrict__ S,
                              const uint32_t* __restrict__ sums,
                              size_t sums_len, size_t off, size_t n, size_t N,
                              size_t s, int inverse, gf::Taps T) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N / 2) return;
  const size_t p = q % (n / 2);
  const size_t c = p % s;
  const size_t i0 = (q / (n / 2)) * n + (p / s) * 2 * s + c, i1 = i0 + s;
  uint32_t x0[W], x1[W], z[W], t[W];
  gf::load<W>(x0, S, N, i0);
  gf::load<W>(x1, S, N, i1);
  gf::load<W>(z, sums, sums_len, off + c);
  if (inverse) {
    gf::add<W>(x1, x1, x0);
    gf::mul<W>(t, x1, z, T);
    gf::add<W>(x0, x0, t);
  } else {
    gf::mul<W>(t, x1, z, T);
    gf::add<W>(x0, x0, t);
    gf::add<W>(x1, x1, x0);
  }
  gf::store<W>(S, N, i0, x0);
  gf::store<W>(S, N, i1, x1);
}

template <int W>
int launch(void* work, void* tmp, const void* tw, const void* sums, int m,
           long long R, int inverse, const uint32_t* taps, void* stream,
           int* launches) {
  const gf::Taps T = gf::taps_from(taps);
  const size_t n = (size_t)1 << m, N = (size_t)R * n;
  const size_t tw_len = 2 * n - 2, sums_len = n - 1;
  auto S = (uint32_t*)work;
  auto D = (uint32_t*)tmp;
  auto TW = (const uint32_t*)tw;
  auto SU = (const uint32_t*)sums;
  auto st = (cudaStream_t)stream;
  int count = 0;
  auto twist = [&](uint32_t* X, int j) {
    twist_kernel<W><<<blocks_for(N), kThreads, 0, st>>>(
        X, TW, tw_len, 2 * n - 2 * (n >> j), n, N, j, T);
    ++count;
  };
  auto radix = [&](uint32_t* X, size_t s) {
    radix_kernel<W><<<blocks_for(N / 4), kThreads, 0, st>>>(X, n, N, s,
                                                           inverse);
    ++count;
  };
  auto unwind = [&](uint32_t* X, int j) {
    unwind_kernel<W><<<blocks_for(N / 2), kThreads, 0, st>>>(
        X, SU, sums_len, ((size_t)1 << j) - 1, n, N, (size_t)1 << j, inverse,
        T);
    ++count;
  };
  if (m > 0 && R > 0) {
    if (!inverse) {
      for (int j = 0; j < m; ++j) {
        twist(S, j);
        for (size_t s = n / 4; s >= ((size_t)1 << j) && s > 0; s >>= 1)
          radix(S, s);
      }
      bitrev_kernel<W><<<blocks_for(N), kThreads, 0, st>>>(D, S, n, N, m);
      ++count;
      for (int j = 0; j < m; ++j) unwind(D, j);
    } else {
      for (int j = m - 1; j >= 0; --j) unwind(S, j);
      bitrev_kernel<W><<<blocks_for(N), kThreads, 0, st>>>(D, S, n, N, m);
      ++count;
      for (int j = m - 1; j >= 0; --j) {
        for (size_t s = (size_t)1 << j; s <= n / 4; s <<= 1) radix(D, s);
        twist(D, j);
      }
    }
  }
  *launches = count;
  return (int)cudaGetLastError();
}

}  // namespace

// work: (W, R, n) input, overwritten; tmp: (W, R, n) output; tw:
// (W, 2n - 2) flat twist powers (the inverse powers when inverse); sums:
// (W, n - 1) flat subset sums; launches: the number of kernels launched
extern "C" int additive_fft_launch(void* work, void* tmp, const void* tw,
                                   const void* sums, int m, long long R,
                                   int inverse, int words,
                                   const uint32_t* taps, void* stream,
                                   int* launches) {
  GF_DISPATCH_WORDS(words, launch, work, tmp, tw, sums, m, R, inverse, taps,
                    stream, launches)
}
