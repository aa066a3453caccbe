// K11: power tables out[i] = start * x^i, i < n, for a device scalar x.
//
// Replaces the JAX reference's _powers_doubling / device_powers
// (libiop_tpu/algebra/domains.py:70/80: log-depth doubling of [x^0 .. x^K)
// and an outer product with the powers of x^K, fused by XLA) and the host
// tables of its MultiplicativeCoset (host_powers, domains.py:27, a Python
// loop of big-int products: twiddles, shift powers, inverse elements).
//
// Design (first, simple): one thread per output.  Thread i runs square and
// multiply over the bits of i (from x, squaring as it goes), starting from
// `start` (or from one when start is null), and writes one element.  The
// canonical Montgomery result is unique, so it equals the reference's table
// limb for limb.  Instantiated for W = 6 (edwards_Fr) and W = 8
// (alt_bn128_Fr).
//
// Bound on the H100: integer instructions.  The table needs one product per
// output (out[i] = out[i-1] * x) against 8W bytes written; this design does
// about 1.5 log2(n) products per output, so it sits well above that bound
// (a two-level table, one product per output, is later work).
//
// GF(2^k) instantiation (W = 2, 4, 6, 8 words; the reference's
// device_powers over a binary field, the port's former doubling loop of
// K16 products and torch.cat): a grid-stride walk.  The launch has G
// threads, G a power of two; thread t computes start * x^t by square and
// multiply and step = x^G by log2(G) squarings, then writes outputs
// t, t + G, t + 2G, ..., one product each.  With G about n / 16 that is
// 16 products a thread after about 1.5 log2(G) of start-up, every write
// coalesced.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

template <int W>
__global__ void powers_kernel(uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ start, size_t n,
                              fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[W], s[W];
  fp::load<W>(s, x, 1, 0);
  fp::load<W>(acc, start, 1, 0);
  for (size_t e = i; e != 0; e >>= 1) {
    if (e & 1) fp::mont_mul<W>(acc, acc, s, P);
    if (e > 1) fp::mont_mul<W>(s, s, s, P);
  }
  fp::store<W>(out, n, i, acc);
}

template <int W>
int launch(void* out, const void* x, const void* start, long long n,
           const uint32_t* field, void* stream) {
  const int threads = 256;
  if (n > 0)
    powers_kernel<W><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)x, (const uint32_t*)start, (size_t)n,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void powers_gf2_kernel(uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ x,
                                  const uint32_t* __restrict__ start, size_t n,
                                  int log_g, gf::Taps T) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint32_t acc[W], s[W], step[W];
  gf::load<W>(s, x, 1, 0);
  gf::load<W>(acc, start, 1, 0);
  gf::copy<W>(step, s);
  for (int q = 0; q < log_g; ++q) gf::square<W>(step, step, T);
  for (size_t e = t; e != 0; e >>= 1) {
    if (e & 1) gf::mul<W>(acc, acc, s, T);
    if (e > 1) gf::square<W>(s, s, T);
  }
  const size_t G = (size_t)1 << log_g;
  for (size_t i = t; i < n; i += G) {
    gf::store<W>(out, n, i, acc);
    if (i + G < n) gf::mul<W>(acc, acc, step, T);
  }
}

template <int W>
int launch_gf2(void* out, const void* x, const void* start, long long n,
               const uint32_t* taps, void* stream) {
  const int threads = 256;
  // G = 2^log_g threads, about n / 16 (each thread then walks 16 products
  // after its ~1.5 log2(G) of start-up), at most 2^17 (132 SMs x 1024)
  int log_g = 0;
  while (log_g < 17 && ((long long)16 << log_g) < n) ++log_g;
  const long long G = (long long)1 << log_g;
  if (n > 0)
    powers_gf2_kernel<W><<<(unsigned)((G + threads - 1) / threads), threads,
                           0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)x, (const uint32_t*)start,
        (size_t)n, log_g, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

}  // namespace

// x, start: one element each, (2W, 1) limbs; out: (2W, n) limbs
extern "C" int powers_launch(void* out, const void* x, const void* start,
                             long long n, int words, const uint32_t* field,
                             void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, x, start, n, field, stream)
}

// GF(2^k): x, start: one element each, (W, 1) words; out: (W, n); taps:
// the field's four reduction taps
extern "C" int powers_gf2_launch(void* out, const void* x, const void* start,
                                 long long n, int words, const uint32_t* taps,
                                 void* stream) {
  GF_DISPATCH_WORDS(words, launch_gf2, out, x, start, n, taps, stream)
}
