// K7: padded-ELL sparse matrix-vector product over the field.
//
// Replaces the JAX reference's SparseMatrix._ell_apply
// (libiop_tpu/relations/sparse.py:87), which computes M z and M^T y for the
// R1CS matrices: a gather of K entries per output row (vals[entry],
// vec[src]), a Montgomery product per entry, a lazy int64 sum over each
// row's K products and one reduction, fused by XLA.
//
// Plan (built once per matrix on the host, kept on the device): output row s
// owns slots s*K .. s*K + K-1 of entry (an index into vals, whose last column
// is a zero the padding slots point at) and src (an index into vec).
//
// Design (first, simple): one thread per output row.  It walks its K slots,
// skips padding, multiplies vals[entry] by vec[src] (CIOS, field.cuh) and
// adds the product into a canonical accumulator mod p; the canonical sum is
// unique, so it equals the reference's lazy sum reduced once.
//
// Instantiated for W = 6 (edwards_Fr) and W = 8 (alt_bn128_Fr) words.
//
// Bound on the H100: memory.  Per row, K pairs of 8W-byte gathers and 16
// bytes of plan against one product and one add per slot; the vec gathers
// are scattered (one thread per row reads columns src[s*K + k]).
//
// GF(2^k) instantiation (W = 2, 4, 6, 8 words; the reference's XOR branch
// of _ell_apply, sparse.py:87-101, with its K16 products): the same one
// thread per output row over the same plan.  Reduction modulo the
// pentanomial is linear over GF(2), so the thread XORs the slots'
// unreduced 2W-word carry-less products (gf::clmul of csrc/gf2k.cuh) and
// reduces once per row, as K15's row_dot_gf2 does.  Integer-instruction
// bound: the Horner clmul costs about 32 (4 W^2 + 2 W) instructions a slot
// against 8W bytes of vals and vec gathers.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

template <int W>
__global__ void ell_matvec_kernel(uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ vals,
                                  size_t nvals,
                                  const long long* __restrict__ entry,
                                  const long long* __restrict__ src,
                                  const uint32_t* __restrict__ vec,
                                  size_t nvec, size_t S, int K,
                                  fp::Params<W> P) {
  const size_t s = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t acc[W], x[W], y[W];
  fp::set_zero<W>(acc);
  const size_t pad = nvals - 1;  // the zero column
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)entry[s * K + k];
    if (e == pad) continue;
    fp::load<W>(x, vals, nvals, e);
    fp::load<W>(y, vec, nvec, (size_t)src[s * K + k]);
    fp::mont_mul<W>(x, x, y, P);
    fp::add_mod<W>(acc, acc, x, P);
  }
  fp::store<W>(out, S, s, acc);
}

template <int W>
int launch(void* out, const void* vals, long long nvals, const void* entry,
           const void* src, const void* vec, long long nvec, long long S,
           int K, const uint32_t* field, void* stream) {
  const int threads = 128;
  if (S > 0)
    ell_matvec_kernel<W><<<(unsigned)((S + threads - 1) / threads), threads,
                           0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)vals, (size_t)nvals,
        (const long long*)entry, (const long long*)src, (const uint32_t*)vec,
        (size_t)nvec, (size_t)S, K, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
__global__ void ell_matvec_gf2_kernel(uint32_t* __restrict__ out,
                                      const uint32_t* __restrict__ vals,
                                      size_t nvals,
                                      const long long* __restrict__ entry,
                                      const long long* __restrict__ src,
                                      const uint32_t* __restrict__ vec,
                                      size_t nvec, size_t S, int K,
                                      gf::Taps T) {
  const size_t s = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t acc[2 * W];
#pragma unroll
  for (int q = 0; q < 2 * W; ++q) acc[q] = 0;
  const size_t pad = nvals - 1;  // the zero column
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)entry[s * K + k];
    if (e == pad) continue;
    uint32_t x[W], y[W], t[2 * W];
    gf::load<W>(x, vals, nvals, e);
    gf::load<W>(y, vec, nvec, (size_t)src[s * K + k]);
    gf::clmul<W>(t, x, y);
#pragma unroll
    for (int q = 0; q < 2 * W; ++q) acc[q] ^= t[q];
  }
  uint32_t res[W];
  gf::reduce<W>(res, acc, T);
  gf::store<W>(out, S, s, res);
}

template <int W>
int launch_gf2(void* out, const void* vals, long long nvals,
               const void* entry, const void* src, const void* vec,
               long long nvec, long long S, int K, const uint32_t* taps,
               void* stream) {
  const int threads = 128;
  if (S > 0)
    ell_matvec_gf2_kernel<W><<<(unsigned)((S + threads - 1) / threads),
                               threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)vals, (size_t)nvals,
        (const long long*)entry, (const long long*)src, (const uint32_t*)vec,
        (size_t)nvec, (size_t)S, K, gf::taps_from(taps));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_matvec_launch(void* out, const void* vals, long long nvals,
                                 const void* entry, const void* src,
                                 const void* vec, long long nvec, long long S,
                                 int K, int words, const uint32_t* field,
                                 void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, vals, nvals, entry, src, vec, nvec, S,
                    K, field, stream)
}

// GF(2^k): vals (W, nvals) words ending with the zero column; vec (W, nvec);
// taps: the field's four reduction taps; out: (W, S)
extern "C" int ell_matvec_gf2_launch(void* out, const void* vals,
                                     long long nvals, const void* entry,
                                     const void* src, const void* vec,
                                     long long nvec, long long S, int K,
                                     int words, const uint32_t* taps,
                                     void* stream) {
  GF_DISPATCH_WORDS(words, launch_gf2, out, vals, nvals, entry, src, vec,
                    nvec, S, K, taps, stream)
}
