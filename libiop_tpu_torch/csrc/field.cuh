// Montgomery arithmetic over a prime field of W 32-bit limbs (R = 2^(32W)),
// the device functions shared by the port's field kernels.  Every function
// is a template on W; the kernels are instantiated for W = 6 (edwards_Fr,
// R = 2^192) and W = 8 (alt_bn128_Fr, R = 2^256).
//
// Memory layout is the port's: a batch of field elements is an int32 tensor
// of shape (2W, n), limbs first, each entry one 16-bit limb (< 2^16).  A
// thread reads its element's 2W limbs (stride n apart, so neighbouring
// threads read neighbouring words) and repacks them into W 32-bit limbs.
// R = 2^(16*2W) = 2^(32*W), so Montgomery values agree bit for bit with the
// JAX reference's 16-bit form (libiop_tpu/fields/prime.py).
//
// Carry chains are written in C++ as 64-bit multiply-adds on 32-bit limbs
// (not as hand-written madc PTX), so every function is also valid host C++
// (HD) and the arithmetic can be exercised without a GPU.
#pragma once
#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace fp {

// the largest word count the kernels are instantiated for
constexpr int kMaxWords = 8;

template <int W>
struct Params {
  uint32_t p[W];  // the modulus, little-endian 32-bit limbs
  uint32_t n0;    // -p^{-1} mod 2^32
};

// The launch-side copy of the field: W words of p, then n0 (the layout of
// PrimeField.kernel_params()).
template <int W>
HD Params<W> params_from(const uint32_t* field) {
  Params<W> P;
  for (int j = 0; j < W; ++j) P.p[j] = field[j];
  P.n0 = field[W];
  return P;
}

// Read the element at batch index idx from a (2W, *) limb array whose limb
// rows are limb_stride entries apart.
template <int W>
HD void load(uint32_t x[W], const uint32_t* src, size_t limb_stride,
             size_t idx) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    x[j] = src[(2 * j) * limb_stride + idx] |
           (src[(2 * j + 1) * limb_stride + idx] << 16);
}

template <int W>
HD void store(uint32_t* dst, size_t limb_stride, size_t idx,
              const uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    dst[(2 * j) * limb_stride + idx] = x[j] & 0xffffu;
    dst[(2 * j + 1) * limb_stride + idx] = x[j] >> 16;
  }
}

template <int W>
HD void set_zero(uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = 0;
}

template <int W>
HD void copy(uint32_t r[W], const uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = x[j];
}

// x holds hi * 2^(32W) + x; replace it by x - p when that value is >= p.
template <int W>
HD void cond_sub(uint32_t x[W], uint32_t hi, const Params<W>& P) {
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t t = (uint64_t)x[j] - P.p[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = t >> 63;
  }
  const bool ge = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = ge ? d[j] : x[j];
}

// r = a + b mod p, for a, b < p.
template <int W>
HD void add_mod(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                const Params<W>& P) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t s = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  cond_sub<W>(r, (uint32_t)c, P);
}

// r = a - b mod p, for a, b < p.
template <int W>
HD void sub_mod(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                const Params<W>& P) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)t;
    borrow = t >> 63;
  }
  if (borrow) {  // wrapped below zero: add p back (mod 2^(32W))
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)r[j] + P.p[j] + c;
      r[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
}

// r = a * b * 2^-(32W) mod p (CIOS Montgomery product), for a, b < p.
// r may alias a or b.
template <int W>
HD void mont_mul(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                 const Params<W>& P) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[W] + c;
    t[W] = (uint32_t)s;
    t[W + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * P.n0;
    s = (uint64_t)m * P.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      s = (uint64_t)m * P.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)s;
    t[W] = t[W + 1] + (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = t[j];
  cond_sub<W>(r, t[W], P);
}

// acc (2W+1 words) += a * b, the full 2W-word product (no reduction), for
// a lazy sum of products that one redc_wide reduces.
template <int W>
HD void mul_wide_acc(uint32_t acc[2 * W + 1], const uint32_t a[W],
                     const uint32_t b[W]) {
  uint32_t t[2 * W];
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + W] = (uint32_t)c;
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) {
    uint64_t s = (uint64_t)acc[j] + t[j] + c;
    acc[j] = (uint32_t)s;
    c = s >> 32;
  }
  acc[2 * W] += (uint32_t)c;
}

// r = T * 2^-(32W) mod p for a (2W+1)-word T < p * 2^(32W) (Montgomery
// reduction of a lazy sum of products; T is overwritten).
template <int W>
HD void redc_wide(uint32_t r[W], uint32_t T[2 * W + 1], const Params<W>& P) {
  uint32_t extra = 0;  // carry out of T[i + W - 1], owed to T[i + W]
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = T[i] * P.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)m * P.p[j] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)T[i + W] + c + extra;
    T[i + W] = (uint32_t)s;
    extra = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = T[W + j];
  cond_sub<W>(r, T[2 * W] + extra, P);
}

}  // namespace fp

// Return impl<W>(args...) for the word count `words` (6 or 8); any other
// count is refused as cudaErrorInvalidValue.  The C launchers take `words`
// from the wrapper (kernels/__init__.py field_words).
#define FP_DISPATCH_WORDS(words, impl, ...)                 \
  switch (words) {                                          \
    case 6: return impl<6>(__VA_ARGS__);                    \
    case 8: return impl<8>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;             \
  }
