// Arithmetic in GF(2^k), k = 32 W, the device functions shared by the
// binary-field kernels (K16-K19 and the binary K8).  Every function is a
// template on W; the kernels are instantiated for W = 2, 4, 6 and 8 (gf64,
// gf128, gf192, gf256).
//
// Memory layout is the port's: a batch of elements is an int32 tensor of
// shape (W, n), words first, bit j of word i the coefficient of x^(32i+j):
// the JAX reference's uint32 words (libiop_tpu/fields/binary.py).  A thread
// reads its element's W words, stride n apart, so neighbouring threads read
// neighbouring words.
//
// The field is x^k + x^t0 + x^t1 + x^t2 + x^t3 with every tap below 32
// (Taps, from BinaryField.kernel_params()).  Hopper has no carry-less
// multiply: the product runs a Horner scheme over the bit positions of a's
// words (t = t*x + sum_i [bit j of a_i] b x^(32 i), a mask and an XOR a
// word), then the reference's two-pass fold of the high words through the
// taps (binary.py:200-221).  The functions are valid host C++ too (GF_HD),
// so the arithmetic can be checked without a GPU.
#pragma once
#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define GF_HD __host__ __device__ __forceinline__
#else
#define GF_HD inline
#endif

namespace gf {

// the largest word count the kernels are instantiated for
constexpr int kMaxWords = 8;

struct Taps {
  uint32_t t[4];
};

GF_HD Taps taps_from(const uint32_t* taps) {
  Taps T;
  for (int q = 0; q < 4; ++q) T.t[q] = taps[q];
  return T;
}

// x >> (32 - s) for s in [0, 32), zero for s = 0: the bits of x << s that
// spill into the next word
GF_HD uint32_t spill(uint32_t x, uint32_t s) { return (x >> 1) >> (31 - s); }

template <int W>
GF_HD void load(uint32_t x[W], const uint32_t* src, size_t stride,
                size_t idx) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = src[j * stride + idx];
}

template <int W>
GF_HD void store(uint32_t* dst, size_t stride, size_t idx,
                 const uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) dst[j * stride + idx] = x[j];
}

template <int W>
GF_HD void copy(uint32_t r[W], const uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = x[j];
}

template <int W>
GF_HD void set_zero(uint32_t r[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = 0;
}

template <int W>
GF_HD void add(uint32_t r[W], const uint32_t a[W], const uint32_t b[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = a[j] ^ b[j];
}

template <int W>
GF_HD bool is_zero(const uint32_t a[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) acc |= a[j];
  return acc == 0;
}

// r = t mod the pentanomial for a 2W-word carry-less product t: fold the
// high W words through the taps (x^(k+s) = x^s (x^t0 + ... + x^t3)), then
// fold the at most max-tap bits that spilled past word W-1 once more.
template <int W>
GF_HD void reduce(uint32_t r[W], const uint32_t t[2 * W], const Taps& T) {
  uint32_t lo[W + 1];
#pragma unroll
  for (int j = 0; j < W; ++j) lo[j] = t[j];
  lo[W] = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t s = T.t[q];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint32_t h = t[W + j];
      lo[j] ^= h << s;
      lo[j + 1] ^= spill(h, s);
    }
  }
  // lo[W] < 2^max_tap and every tap <= 10 < 16: h << s stays in word 0
  const uint32_t h = lo[W];
#pragma unroll
  for (int q = 0; q < 4; ++q) lo[0] ^= h << T.t[q];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = lo[j];
}

// t = a * b carry-less (2W words): Horner over the bit positions j = 31..0
// of a's words.  Reads a and b in full before t is complete, so r may
// alias a or b in mul().
template <int W>
GF_HD void clmul(uint32_t t[2 * W], const uint32_t a[W], const uint32_t b[W]) {
#pragma unroll
  for (int i = 0; i < 2 * W; ++i) t[i] = 0;
#pragma unroll 1
  for (int j = 31; j >= 0; --j) {
#pragma unroll
    for (int i = 2 * W - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
    t[0] <<= 1;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t m = 0u - ((a[i] >> j) & 1u);
#pragma unroll
      for (int l = 0; l < W; ++l) t[i + l] ^= b[l] & m;
    }
  }
}

template <int W>
GF_HD void mul(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
               const Taps& T) {
  uint32_t t[2 * W];
  clmul<W>(t, a, b);
  reduce<W>(r, t, T);
}

// bit i of the low 16 bits of x -> bit 2i
GF_HD uint32_t spread16(uint32_t x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// squaring is linear in characteristic 2: interleave zeros, then reduce
template <int W>
GF_HD void square(uint32_t r[W], const uint32_t a[W], const Taps& T) {
  uint32_t t[2 * W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    t[2 * j] = spread16(a[j]);
    t[2 * j + 1] = spread16(a[j] >> 16);
  }
  reduce<W>(r, t, T);
}

// r = a^(2^k - 2) = a^-1 (0 for a = 0) by the Itoh-Tsujii chain of the
// reference (binary.py:390-408): with res = a^(2^e - 1), e runs over the
// binary expansion of k - 1 (e -> 2e: res^(2^e) * res; e -> e + 1:
// res^2 * a), then one squaring.  k - 1 squarings and about log2(k) +
// popcount(k - 1) products, all in registers.
template <int W>
GF_HD void inv(uint32_t r[W], const uint32_t a[W], const Taps& T) {
  constexpr int m = 32 * W - 1;
  int hb = 0;
  while ((m >> (hb + 1)) != 0) ++hb;
  uint32_t res[W], tmp[W];
  copy<W>(res, a);
  int e = 1;
#pragma unroll 1
  for (int bit = hb - 1; bit >= 0; --bit) {
    copy<W>(tmp, res);
#pragma unroll 1
    for (int s = 0; s < e; ++s) square<W>(tmp, tmp, T);
    mul<W>(res, tmp, res, T);
    e *= 2;
    if ((m >> bit) & 1) {
      square<W>(tmp, res, T);
      mul<W>(res, tmp, a, T);
      e += 1;
    }
  }
  square<W>(r, res, T);
}

}  // namespace gf

// Instantiate impl<W> for the binary fields' word counts.
#define GF_DISPATCH_WORDS(words, impl, ...)                 \
  switch (words) {                                          \
    case 2: return impl<2>(__VA_ARGS__);                    \
    case 4: return impl<4>(__VA_ARGS__);                    \
    case 6: return impl<6>(__VA_ARGS__);                    \
    case 8: return impl<8>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;             \
  }
