// K10: blocked Horner evaluation of one polynomial at k points.
//
// Replaces the JAX reference's horner_eval (libiop_tpu/algebra/poly.py:184,
// reached through lincheck's pair evaluation, protocols/lincheck.py:53/173):
// for d > 256 coefficients it writes p(x) = sum_s x^(m s) q_s(x) with
// S = ceil(d / m) chunks of m = 2^ceil(log2(d) / 2) coefficients, runs one
// m-step scan over all (chunk, point) pairs and then an S-step Horner in
// x^m per point; at most 256 coefficients it is one d-step scan (one chunk,
// m = d).  Field ops are exact, so every split gives the same value.
//
// Design (first, simple): two launches.  chunks: one thread per (chunk s,
// point j) runs Horner over coefficients s*m .. s*m + m-1 (those at or past
// d count as zero) at x_j and writes q_s(x_j) to acc (2W, S*k) at column
// s*k + j; with S = 1 that is the result.  combine: one thread per point
// computes x^m by log2(m) squarings and runs Horner over the S chunk values
// in x^m.  Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: integer instructions.  Per point the evaluation needs
// about d products and d adds against 8W d bytes of coefficients, which the
// k points share (read once from device memory, then from L2).
//
// GF(2^k) instantiation (W = 2, 4, 6, 8 words; the reference's horner_eval
// over a binary field, the port's former K16-and-torch split): the same
// split and the same two launches, one thread per (chunk, point) and one
// per point, with the product and the square of csrc/gf2k.cuh and XOR for
// the add.  Each Horner step reduces its product (the next step multiplies
// it), so the cost is d products a point, a Horner clmul of about
// 32 (4 W^2 + 2 W) instructions each plus the fold.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

template <int W>
__global__ void chunks_kernel(uint32_t* __restrict__ acc,
                              const uint32_t* __restrict__ coeffs,
                              const uint32_t* __restrict__ x, size_t d,
                              size_t m, size_t S, size_t k, fp::Params<W> P) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * k) return;
  const size_t s = t / k, j = t - s * k;
  uint32_t xv[W], r[W], c[W];
  fp::load<W>(xv, x, k, j);
  fp::set_zero<W>(r);
  for (size_t e = m; e-- > 0;) {
    fp::mont_mul<W>(r, r, xv, P);
    const size_t idx = s * m + e;
    if (idx < d) {
      fp::load<W>(c, coeffs, d, idx);
      fp::add_mod<W>(r, r, c, P);
    }
  }
  fp::store<W>(acc, S * k, t, r);
}

template <int W>
__global__ void combine_kernel(uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ acc,
                               const uint32_t* __restrict__ x, size_t m,
                               size_t S, size_t k, fp::Params<W> P) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  uint32_t xm[W], r[W], c[W];
  fp::load<W>(xm, x, k, j);
  for (size_t e = m; e > 1; e >>= 1) fp::mont_mul<W>(xm, xm, xm, P);
  fp::set_zero<W>(r);
  for (size_t s = S; s-- > 0;) {
    fp::mont_mul<W>(r, r, xm, P);
    fp::load<W>(c, acc, S * k, s * k + j);
    fp::add_mod<W>(r, r, c, P);
  }
  fp::store<W>(out, k, j, r);
}

template <int W>
int launch_chunks(void* acc, const void* coeffs, const void* x, long long d,
                  long long m, long long S, long long k,
                  const uint32_t* field, void* stream) {
  const int threads = 128;
  const long long work = S * k;
  if (work > 0)
    chunks_kernel<W><<<(unsigned)((work + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(
        (uint32_t*)acc, (const uint32_t*)coeffs, (const uint32_t*)x,
        (size_t)d, (size_t)m, (size_t)S, (size_t)k, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
int launch_combine(void* out, const void* acc, const void* x, long long m,
                   long long S, long long k, const uint32_t* field,
                   void* stream) {
  const int threads = 128;
  if (k > 0)
    combine_kernel<W><<<(unsigned)((k + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)acc, (const uint32_t*)x, (size_t)m,
        (size_t)S, (size_t)k, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void chunks_gf2_kernel(uint32_t* __restrict__ acc,
                                  const uint32_t* __restrict__ coeffs,
                                  const uint32_t* __restrict__ x, size_t d,
                                  size_t m, size_t S, size_t k, gf::Taps T) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * k) return;
  const size_t s = t / k, j = t - s * k;
  uint32_t xv[W], r[W], c[W];
  gf::load<W>(xv, x, k, j);
  gf::set_zero<W>(r);
  for (size_t e = m; e-- > 0;) {
    gf::mul<W>(r, r, xv, T);
    const size_t idx = s * m + e;
    if (idx < d) {
      gf::load<W>(c, coeffs, d, idx);
      gf::add<W>(r, r, c);
    }
  }
  gf::store<W>(acc, S * k, t, r);
}

template <int W>
__global__ void combine_gf2_kernel(uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ acc,
                                   const uint32_t* __restrict__ x, size_t m,
                                   size_t S, size_t k, gf::Taps T) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  uint32_t xm[W], r[W], c[W];
  gf::load<W>(xm, x, k, j);
  for (size_t e = m; e > 1; e >>= 1) gf::square<W>(xm, xm, T);
  gf::set_zero<W>(r);
  for (size_t s = S; s-- > 0;) {
    gf::mul<W>(r, r, xm, T);
    gf::load<W>(c, acc, S * k, s * k + j);
    gf::add<W>(r, r, c);
  }
  gf::store<W>(out, k, j, r);
}

template <int W>
int launch_chunks_gf2(void* acc, const void* coeffs, const void* x,
                      long long d, long long m, long long S, long long k,
                      const uint32_t* taps, void* stream) {
  const int threads = 128;
  const long long work = S * k;
  if (work > 0)
    chunks_gf2_kernel<W><<<(unsigned)((work + threads - 1) / threads),
                           threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)acc, (const uint32_t*)coeffs, (const uint32_t*)x,
        (size_t)d, (size_t)m, (size_t)S, (size_t)k, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

template <int W>
int launch_combine_gf2(void* out, const void* acc, const void* x,
                       long long m, long long S, long long k,
                       const uint32_t* taps, void* stream) {
  const int threads = 128;
  if (k > 0)
    combine_gf2_kernel<W><<<(unsigned)((k + threads - 1) / threads), threads,
                            0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)acc, (const uint32_t*)x, (size_t)m,
        (size_t)S, (size_t)k, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

}  // namespace

// coeffs: (2W, d); x: (2W, k); acc: (2W, S*k), column s*k + j = q_s(x_j)
extern "C" int horner_chunks_launch(void* acc, const void* coeffs,
                                    const void* x, long long d, long long m,
                                    long long S, long long k, int words,
                                    const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch_chunks, acc, coeffs, x, d, m, S, k, field,
                    stream)
}

// out: (2W, k) = sum_s (x^m)^s acc[:, s*k + j]; m a power of two
extern "C" int horner_combine_launch(void* out, const void* acc, const void* x,
                                     long long m, long long S, long long k,
                                     int words, const uint32_t* field,
                                     void* stream) {
  FP_DISPATCH_WORDS(words, launch_combine, out, acc, x, m, S, k, field,
                    stream)
}

// GF(2^k): coeffs (W, d) words; x (W, k); acc (W, S*k); taps: the field's
// four reduction taps
extern "C" int horner_chunks_gf2_launch(void* acc, const void* coeffs,
                                        const void* x, long long d,
                                        long long m, long long S, long long k,
                                        int words, const uint32_t* taps,
                                        void* stream) {
  GF_DISPATCH_WORDS(words, launch_chunks_gf2, acc, coeffs, x, d, m, S, k,
                    taps, stream)
}

// GF(2^k): out (W, k) = sum_s (x^m)^s acc[:, s*k + j]; m a power of two
extern "C" int horner_combine_gf2_launch(void* out, const void* acc,
                                         const void* x, long long m,
                                         long long S, long long k, int words,
                                         const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch_combine_gf2, out, acc, x, m, S, k, taps,
                    stream)
}
