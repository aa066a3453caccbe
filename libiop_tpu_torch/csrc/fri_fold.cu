// K4: one multiplicative FRI fold of a natural-order codeword.
//
// Replaces the JAX reference's _build_fold_fn (libiop_tpu/protocols/fri.py:133,
// called by fold_codeword:177).  Over the coset {h_j g^k : k < c} of output j
// (positions j + k*nc, nc = N/c, c = 2^eta) the codeword equals
// p_j(u) = sum_t a_t u^t with a_t = (1/c) sum_k g^{-tk} v[k*nc + j], and the
// folded value is p_j(x / h_j) = sum_t a_t * G^{-jt} * (x/shift)^t, G the
// domain generator (fri.py:159-172).
//
// Design (first, simple): one thread per output j.  It gathers its c values
// (stride nc apart, so neighbouring threads read neighbouring words), runs
// the c x c inverse mini-NTT from the table rows[t*c + k] = (1/c) g^{-tk},
// multiplies each a_t by the twiddle Winv[(j*t) mod N] and by xpow[t] =
// (x/shift)^t, and sums mod p.  Tables and the challenge powers are small
// inputs built by the host wrapper.  The output is fully reduced, so it equals
// the reference's lazily-summed fold limb for limb.
//
// Bound on the H100: integer instruction throughput.  This design does
// c^2 + 2c Montgomery products per output (24 at c = 4) against 8W (c + 1)
// bytes moved (W = 6 or 8 words per element, one instantiation each).  The
// fold itself needs far fewer (6 at c = 4): a radix-2 inverse mini-NTT whose
// twiddles of 1 are free, then Horner in y_j = G^-j * x/shift, which also
// needs only the twiddles G^-j (later work).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W, int C>
__global__ void fri_fold_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ v,
                                const uint32_t* __restrict__ rows,
                                const uint32_t* __restrict__ winv,
                                const uint32_t* __restrict__ xpow, size_t N,
                                fp::Params<W> P) {
  const size_t nc = N / C;
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nc) return;
  uint32_t vals[C][W];
#pragma unroll
  for (int k = 0; k < C; ++k) fp::load<W>(vals[k], v, N, k * nc + j);
  uint32_t acc[W];
  fp::set_zero<W>(acc);
  // the loop over t stays rolled (its body indexes vals statically): fully
  // unrolled, its c^2 inlined products kept ptxas busy for 27 s at W = 8,
  // c = 8, most of the kernels' build
#pragma unroll 1
  for (int t = 0; t < C; ++t) {
    uint32_t a[W];
    fp::set_zero<W>(a);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      uint32_t w[W];
      fp::load<W>(w, rows, C * C, t * C + k);
      fp::mont_mul<W>(w, w, vals[k], P);
      fp::add_mod<W>(a, a, w, P);
    }
    uint32_t w[W];
    fp::load<W>(w, winv, N, (j * t) % N);
    fp::mont_mul<W>(a, a, w, P);
    fp::load<W>(w, xpow, C, t);
    fp::mont_mul<W>(a, a, w, P);
    fp::add_mod<W>(acc, acc, a, P);
  }
  fp::store<W>(out, nc, j, acc);
}

template <int W, int C>
void launch_c(uint32_t* out, const uint32_t* v, const uint32_t* rows,
              const uint32_t* winv, const uint32_t* xpow, size_t N,
              const fp::Params<W>& P, cudaStream_t stream) {
  const size_t nc = N / C;
  const int threads = 128;
  fri_fold_kernel<W, C><<<(unsigned)((nc + threads - 1) / threads), threads, 0,
                          stream>>>(out, v, rows, winv, xpow, N, P);
}

template <int W>
int launch(void* out, const void* v, const void* rows, const void* winv,
           const void* xpow, long long N, int c, const uint32_t* field,
           void* stream) {
  const fp::Params<W> P = fp::params_from<W>(field);
  auto o = (uint32_t*)out;
  auto vv = (const uint32_t*)v;
  auto r = (const uint32_t*)rows;
  auto w = (const uint32_t*)winv;
  auto x = (const uint32_t*)xpow;
  auto s = (cudaStream_t)stream;
  switch (c) {
    case 2: launch_c<W, 2>(o, vv, r, w, x, (size_t)N, P, s); break;
    case 4: launch_c<W, 4>(o, vv, r, w, x, (size_t)N, P, s); break;
    case 8: launch_c<W, 8>(o, vv, r, w, x, (size_t)N, P, s); break;
    case 16: launch_c<W, 16>(o, vv, r, w, x, (size_t)N, P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fri_fold_launch(void* out, const void* v, const void* rows,
                               const void* winv, const void* xpow, long long N,
                               int c, int words, const uint32_t* field,
                               void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, v, rows, winv, xpow, N, c, field,
                    stream)
}
