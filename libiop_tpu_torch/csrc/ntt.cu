// K2: one radix-2 decimation-in-time butterfly stage of the NTT, in place.
//
// Replaces the JAX reference's _butterfly_stages (libiop_tpu/algebra/fft.py:103,
// run by _fft_impl:136 / _ifft_impl:173): per stage m, reshape to
// (N/2m, 2m) blocks, t = w_j * b, (a + t, a - t), fused by XLA.
//
// Design (first, simple): one launch per stage, one thread per butterfly over
// all rows of a (2W, rows, N) limb array.  Butterfly (row, blk, j) pairs
// positions blk*2m + j and blk*2m + j + m of its row, and its twiddle is
// Wt[j * N/(2m)] from the (2W, N) table of generator powers, exactly the
// reference's strided slice.  Pairs are disjoint, so the update is in place.
// The host glue (bit reversal, degree-aware duplication, shift and 1/N
// scaling) stays in PyTorch with K1 for the products.
//
// Bound on the H100: memory.  Each stage reads and writes the whole array
// (2 x 8W bytes per element with int32 limbs) for one Montgomery product per
// butterfly; a fused multi-stage kernel in shared memory is the later design.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ Wt, size_t rows,
                                 size_t N, size_t m, fp::Params<W> P) {
  const size_t half = N >> 1;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * half) return;
  const size_t row = t / half;
  const size_t k = t - row * half;
  const size_t blk = k / m;
  const size_t j = k - blk * m;
  const size_t i0 = row * N + blk * 2 * m + j;
  const size_t i1 = i0 + m;
  const size_t stride = rows * N;
  uint32_t a[W], b[W], w[W], r[W];
  fp::load<W>(a, x, stride, i0);
  fp::load<W>(b, x, stride, i1);
  fp::load<W>(w, Wt, N, j * (N / (2 * m)));
  fp::mont_mul<W>(b, w, b, P);
  fp::add_mod<W>(r, a, b, P);
  fp::sub_mod<W>(a, a, b, P);
  fp::store<W>(x, stride, i0, r);
  fp::store<W>(x, stride, i1, a);
}

template <int W>
int launch(void* x, const void* Wt, long long rows, long long N, long long m,
           const uint32_t* field, void* stream) {
  const long long work = rows * (N / 2);
  const int threads = 256;
  if (work > 0)
    ntt_stage_kernel<W><<<(unsigned)((work + threads - 1) / threads), threads,
                          0, (cudaStream_t)stream>>>(
        (uint32_t*)x, (const uint32_t*)Wt, (size_t)rows, (size_t)N, (size_t)m,
        fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt_stage_launch(void* x, const void* Wt, long long rows,
                                long long N, long long m, int words,
                                const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, x, Wt, rows, N, m, field, stream)
}
