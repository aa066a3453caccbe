// K14: batched Reed-Solomon row encode.  Each row of m values on a source
// subgroup S (order m) is interpolated (INTT over S) and its polynomial
// evaluated over the codeword coset D = shift * <g_D> of order N = 2^e m.
//
// Replaces the JAX reference's _encode_rows (libiop_tpu/protocols/ligero.py:86:
// ifft_any over the systematic domain, then fft_any over the codeword
// domain, each a chain of XLA-fused butterfly stages), and the zk row
// blinding oracle's extended-domain-to-codeword encode (ligero.py:613-628).
//
// Design (first, simple): with g_D^(2^e) = g_S, the evaluations at the
// indices i = r + 2^e k (k < m) of D are a size-m NTT over S of the
// coefficients c_j scaled by (shift * g_D^r)^j.  One block per (row, r)
// keeps the row's m elements in shared memory (W 32-bit words each, one
// word plane per limb pair, so that neighbouring threads touch
// neighbouring words) and runs, without leaving it:
//   1. load the row in bit-reversed order;
//   2. radix-2 DIT over S with the inverse twiddles (INTT, natural order);
//   3. c_j * (1/m) * s_S^-j * shift^j * g_D^(r j) (the source's shift
//      factor only when it is not 1);
//   4. bit-reverse in place (disjoint swaps), DIT over S with the twiddles
//      g_D^(N/2h * t) read from D's table;
//   5. write element k to column r + 2^e k of the row's codeword.
// Each of the 2^e blocks of a row repeats the INTT (step 2): 2^e times the
// interpolation's products, in exchange for one launch per encode and no
// coefficient buffer in device memory.  The same canonical Montgomery
// values come out as from the reference's two transforms.  Above 48 KB of
// shared memory (m = 2^12 at W = 8) the launcher raises the kernel's
// dynamic shared-memory limit; above the card's 227 KB the wrapper refuses.
//
// Bound on the H100: integer instructions at the paths' shapes (a row of
// 2^10 elements carries about 2^10 * 10 / 2 * (1 + 2^e) products against
// 48 * 2^10 * (1 + 2^e) bytes).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ unsigned bitrev(unsigned k, int logm) {
  return logm == 0 ? 0u : (__brev(k) >> (32 - logm));
}

template <int W>
__device__ __forceinline__ void sload(uint32_t x[W], const uint32_t* s,
                                      unsigned m, unsigned k) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = s[j * m + k];
}

template <int W>
__device__ __forceinline__ void sstore(uint32_t* s, unsigned m, unsigned k,
                                       const uint32_t x[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) s[j * m + k] = x[j];
}

// Radix-2 DIT over the m elements in shared memory (bit-reversed in,
// natural out).  tw is a (2W, tw_n) table of the powers of a generator of
// order tw_n, whose (tw_n/m)-th power is the transform's root; the
// butterfly at offset t of a stage of half-size h uses tw[t * tw_n / 2h].
template <int W>
__device__ void block_dit(uint32_t* s, unsigned m, const uint32_t* tw,
                          size_t tw_n, const fp::Params<W>& P) {
  for (unsigned h = 1; h < m; h <<= 1) {
    const size_t step = tw_n / (2 * (size_t)h);
    for (unsigned b = threadIdx.x; b < m / 2; b += blockDim.x) {
      const unsigned blk = b / h;
      const unsigned t = b - blk * h;
      const unsigned i0 = blk * 2 * h + t;
      uint32_t a[W], c[W], r[W];
      sload<W>(a, s, m, i0);
      sload<W>(c, s, m, i0 + h);
      if (t != 0) {
        uint32_t w[W];
        fp::load<W>(w, tw, tw_n, t * step);
        fp::mont_mul<W>(c, w, c, P);
      }
      fp::add_mod<W>(r, a, c, P);
      fp::sub_mod<W>(a, a, c, P);
      sstore<W>(s, m, i0, r);
      sstore<W>(s, m, i0 + h, a);
    }
    __syncthreads();
  }
}

// x = c_j * (1/m) * s_S^-j * shift^j * g_D^(r j), x holding c_j.
template <int W>
__device__ __forceinline__ void scale(uint32_t x[W], unsigned j,
                                      const uint32_t im[W],
                                      const uint32_t* sinv_src,
                                      const uint32_t* spow_dst,
                                      const uint32_t* g_dst, unsigned m,
                                      size_t N, unsigned r,
                                      const fp::Params<W>& P) {
  uint32_t f[W];
  fp::mont_mul<W>(x, x, im, P);
  if (sinv_src != nullptr) {
    fp::load<W>(f, sinv_src, m, j);
    fp::mont_mul<W>(x, x, f, P);
  }
  if (spow_dst != nullptr) {
    fp::load<W>(f, spow_dst, N, j);
    fp::mont_mul<W>(x, x, f, P);
  }
  if (r != 0) {
    fp::load<W>(f, g_dst, N, ((size_t)r * j) & (N - 1));
    fp::mont_mul<W>(x, x, f, P);
  }
}

template <int W>
__global__ void rs_encode_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ values,
    const uint32_t* __restrict__ winv_src, const uint32_t* __restrict__ inv_m,
    const uint32_t* __restrict__ sinv_src, const uint32_t* __restrict__ g_dst,
    const uint32_t* __restrict__ spow_dst, size_t rows, unsigned m, int logm,
    int e, fp::Params<W> P) {
  extern __shared__ uint32_t s[];
  const size_t row = blockIdx.x >> e;
  const unsigned r = blockIdx.x & ((1u << e) - 1);
  const size_t N = (size_t)m << e;
  // 1. the row, bit-reversed
  for (unsigned k = threadIdx.x; k < m; k += blockDim.x) {
    uint32_t x[W];
    fp::load<W>(x, values, rows * m, row * m + k);
    sstore<W>(s, m, bitrev(k, logm), x);
  }
  __syncthreads();
  // 2. interpolate over the source subgroup
  block_dit<W>(s, m, winv_src, m, P);
  // 3. scale coefficient j, then 4a. move it to its bit-reversed slot (each
  //    pair (j, bitrev(j)) belongs to the thread of its smaller index)
  uint32_t im[W];
  fp::load<W>(im, inv_m, 1, 0);
  for (unsigned j = threadIdx.x; j < m; j += blockDim.x) {
    const unsigned jr = bitrev(j, logm);
    if (jr < j) continue;
    uint32_t x[W], y[W];
    sload<W>(x, s, m, j);
    scale<W>(x, j, im, sinv_src, spow_dst, g_dst, m, N, r, P);
    if (jr != j) {
      sload<W>(y, s, m, jr);
      scale<W>(y, jr, im, sinv_src, spow_dst, g_dst, m, N, r, P);
      sstore<W>(s, m, j, y);
    }
    sstore<W>(s, m, jr, x);
  }
  __syncthreads();
  // 4b. evaluate over the source subgroup: g_S = g_D^(2^e)
  block_dit<W>(s, m, g_dst, N, P);
  // 5. element k is the evaluation at index r + 2^e k of D
  for (unsigned k = threadIdx.x; k < m; k += blockDim.x) {
    uint32_t x[W];
    sload<W>(x, s, m, k);
    fp::store<W>(out, rows * N, row * N + r + ((size_t)k << e), x);
  }
}

template <int W>
int launch(void* out, const void* values, const void* winv_src,
           const void* inv_m, const void* sinv_src, const void* g_dst,
           const void* spow_dst, long long rows, long long m, int e,
           const uint32_t* field, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  int logm = 0;
  while ((1LL << logm) < m) ++logm;
  const size_t smem = (size_t)m * W * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rs_encode_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long threads = m / 2;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  rs_encode_kernel<W><<<(unsigned)(rows << e), (unsigned)threads, smem,
                        (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)values, (const uint32_t*)winv_src,
      (const uint32_t*)inv_m, (const uint32_t*)sinv_src,
      (const uint32_t*)g_dst, (const uint32_t*)spow_dst, (size_t)rows,
      (unsigned)m, logm, e, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

// values: (2W, rows, m); winv_src: (2W, m) inverse generator powers of the
// source subgroup; inv_m: (2W, 1) the Montgomery form of 1/m; sinv_src:
// (2W, m) inverse shift powers of the source, or null for shift 1; g_dst,
// spow_dst: (2W, N) generator and shift powers of the codeword domain
// (spow_dst null for shift 1), N = 2^e m; out: (2W, rows, N)
extern "C" int rs_encode_launch(void* out, const void* values,
                                const void* winv_src, const void* inv_m,
                                const void* sinv_src, const void* g_dst,
                                const void* spow_dst, long long rows,
                                long long m, int e, int words,
                                const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, values, winv_src, inv_m, sinv_src,
                    g_dst, spow_dst, rows, m, e, field, stream)
}
