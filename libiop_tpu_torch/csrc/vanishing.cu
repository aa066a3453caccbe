// K12: multiplication and division by a coset's vanishing polynomial
// Z(x) = x^h - a.
//
// Replaces the JAX reference's mul_by_vanishing / divide_by_vanishing
// (libiop_tpu/algebra/poly.py:87/101, called from
// protocols/r1cs_rs_iop.py:290-300 and sumcheck.py:227).  The reference
// divides by weighting the coefficient blocks B_t (f = sum_t B_t x^(th))
// with a^t, taking chunked lazy suffix sums and scaling block t by
// a^(-t-1); here the division is the synthetic division by y - a in
// y = x^h, column by column, which gives the same (unique) quotient and
// remainder.
//
// divide: Q_(nb-2) = B_(nb-1), Q_(t-1) = B_t + a * Q_t from the top block
// down, remainder B_0 + a * Q_0, column by column: acc_t = B_t + a acc_(t+1)
// (acc_nb = 0) is a linear recurrence, so it is split into nc chunks of G
// blocks and run in three passes (the wrapper picks G; nc = 1 is one pass):
//   1. one thread per (chunk, column) runs its chunk from zero and keeps the
//      chunk's sum S_c = sum over its blocks of a^(t - lo_c) B_t;
//   2. one thread per column walks the chunks from the top and keeps each
//      chunk's carry-in acc_(hi_c): acc_(lo_c) = S_c + a^G acc_(hi_c);
//   3. one thread per (chunk, column) runs its chunk again from its carry-in
//      and writes Q and the remainder.
// So the serial depth is about 3 sqrt(nb) steps, not nb, when h is small
// (the input domain's h = 16 has nb in the thousands).  Quotient block t
// goes to columns t*h .. t*h + h-1 of q (2W, (nb-1)*h).
// multiply: one thread per output column i < d + h,
// out[i] = (i < d ? neg_a * f[i] : 0) + (i >= h ? f[i - h] : 0), with
// neg_a = -a (one launch, where the reference runs a product and an add).
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr).
//
// Bound on the H100: memory.  Each coefficient is read once and each output
// written once (8W bytes each) against one product and one add per
// coefficient; the chunked division reads f twice and does two products per
// coefficient.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// Passes 1 and 3 over chunk c = idx / h, column i = idx % h: blocks
// [c G, min(c G + G, nb)) from the top, acc = B_t + a acc, starting from
// carry[c] (pass 3 of three) or zero.  With `final` (pass 3, or the one
// pass when nc = 1) it writes Q_(t-1) = acc_t and the remainder acc_0 (q is
// empty when nb = 1); pass 1 writes its last acc to sums[c].
template <int W>
__global__ void chunk_kernel(uint32_t* __restrict__ q,
                             uint32_t* __restrict__ rem,
                             uint32_t* __restrict__ sums,
                             const uint32_t* __restrict__ carry,
                             const uint32_t* __restrict__ f,
                             const uint32_t* __restrict__ a, size_t h,
                             size_t nb, size_t G, size_t nc, bool final,
                             fp::Params<W> P) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nc * h) return;
  const size_t c = idx / h, i = idx % h;
  const size_t d = nb * h, qn = (nb - 1) * h, lo = c * G;
  const size_t hi = lo + G < nb ? lo + G : nb;
  uint32_t av[W], acc[W], b[W];
  fp::load<W>(av, a, 1, 0);
  if (carry != nullptr)
    fp::load<W>(acc, carry, nc * h, idx);
  else
    fp::set_zero<W>(acc);
  for (size_t t = hi; t-- > lo;) {
    fp::load<W>(b, f, d, t * h + i);
    fp::mont_mul<W>(acc, acc, av, P);
    fp::add_mod<W>(acc, acc, b, P);
    if (final) {
      if (t > 0)
        fp::store<W>(q, qn, (t - 1) * h + i, acc);
      else
        fp::store<W>(rem, h, i, acc);
    }
  }
  if (!final) fp::store<W>(sums, nc * h, idx, acc);
}

// Pass 2, one thread per column i: carry[c] = acc at the top of chunk c,
// from the top chunk (carry 0) down, acc_(lo_c) = S_c + a^G acc_(hi_c).
template <int W>
__global__ void carry_kernel(uint32_t* __restrict__ carry,
                             const uint32_t* __restrict__ sums,
                             const uint32_t* __restrict__ a, size_t h,
                             size_t G, size_t nc, fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  uint32_t av[W], aG[W], acc[W], s[W];
  fp::load<W>(av, a, 1, 0);
  int hb = 0;  // aG = a^G, square and multiply from the top bit of G
  while ((G >> (hb + 1)) != 0) ++hb;
  fp::copy<W>(aG, av);
  for (int bit = hb - 1; bit >= 0; --bit) {
    fp::mont_mul<W>(aG, aG, aG, P);
    if ((G >> bit) & 1) fp::mont_mul<W>(aG, aG, av, P);
  }
  fp::set_zero<W>(acc);
  for (size_t c = nc; c-- > 0;) {
    fp::store<W>(carry, nc * h, c * h + i, acc);
    fp::load<W>(s, sums, nc * h, c * h + i);
    fp::mont_mul<W>(acc, acc, aG, P);
    fp::add_mod<W>(acc, acc, s, P);
  }
}

template <int W>
__global__ void multiply_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ f,
                                const uint32_t* __restrict__ neg_a, size_t d,
                                size_t h, fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = d + h;
  if (i >= n) return;
  uint32_t acc[W], x[W];
  fp::set_zero<W>(acc);
  if (i < d) {
    fp::load<W>(acc, neg_a, 1, 0);
    fp::load<W>(x, f, d, i);
    fp::mont_mul<W>(acc, acc, x, P);
  }
  if (i >= h) {
    fp::load<W>(x, f, d, i - h);
    fp::add_mod<W>(acc, acc, x, P);
  }
  fp::store<W>(out, n, i, acc);
}

template <int W>
int launch_divide(void* q, void* rem, const void* f, const void* a,
                  void* scratch, long long h, long long nb, long long G,
                  const uint32_t* field, void* stream) {
  const int threads = 128;
  if (nb < 1 || G < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const long long nc = (nb + G - 1) / G;
  const cudaStream_t s = (cudaStream_t)stream;
  const fp::Params<W> P = fp::params_from<W>(field);
  const unsigned grid = (unsigned)((nc * h + threads - 1) / threads);
  uint32_t* sums = (uint32_t*)scratch;
  uint32_t* carry = nullptr;
  if (nc > 1) {
    carry = sums + 2 * W * nc * h;
    chunk_kernel<W><<<grid, threads, 0, s>>>(
        nullptr, nullptr, sums, nullptr, (const uint32_t*)f,
        (const uint32_t*)a, (size_t)h, (size_t)nb, (size_t)G, (size_t)nc,
        false, P);
    carry_kernel<W><<<(unsigned)((h + threads - 1) / threads), threads, 0,
                      s>>>(carry, sums, (const uint32_t*)a, (size_t)h,
                           (size_t)G, (size_t)nc, P);
  }
  chunk_kernel<W><<<grid, threads, 0, s>>>(
      (uint32_t*)q, (uint32_t*)rem, nullptr, carry, (const uint32_t*)f,
      (const uint32_t*)a, (size_t)h, (size_t)nb, (size_t)G, (size_t)nc, true,
      P);
  return (int)cudaGetLastError();
}

template <int W>
int launch_multiply(void* out, const void* f, const void* neg_a, long long d,
                    long long h, const uint32_t* field, void* stream) {
  const int threads = 256;
  const long long n = d + h;
  if (n > 0)
    multiply_kernel<W><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)f, (const uint32_t*)neg_a, (size_t)d,
        (size_t)h, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

// f: (2W, nb*h) coefficients; q: (2W, (nb-1)*h); rem: (2W, h); a: (2W, 1);
// G blocks per chunk; scratch: (2W, 2*nc*h) when nc = ceil(nb / G) > 1.
// Launches 1 kernel when nc = 1, else 3.
extern "C" int vanishing_divide_launch(void* q, void* rem, const void* f,
                                       const void* a, void* scratch,
                                       long long h, long long nb, long long G,
                                       int words, const uint32_t* field,
                                       void* stream) {
  FP_DISPATCH_WORDS(words, launch_divide, q, rem, f, a, scratch, h, nb, G,
                    field, stream)
}

// f: (2W, d); out: (2W, d + h); neg_a: (2W, 1)
extern "C" int vanishing_multiply_launch(void* out, const void* f,
                                         const void* neg_a, long long d,
                                         long long h, int words,
                                         const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch_multiply, out, f, neg_a, d, h, field,
                    stream)
}
