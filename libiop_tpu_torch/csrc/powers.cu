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
#include <cuda_runtime.h>

#include "field.cuh"

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

}  // namespace

// x, start: one element each, (2W, 1) limbs; out: (2W, n) limbs
extern "C" int powers_launch(void* out, const void* x, const void* start,
                             long long n, int words, const uint32_t* field,
                             void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, x, start, n, field, stream)
}
