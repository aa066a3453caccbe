// K2: the radix-2 decimation-in-time butterfly stages of the NTT, in place,
// several stages a launch in shared memory.
//
// Replaces the JAX reference's _butterfly_stages (libiop_tpu/algebra/fft.py:103,
// run by _fft_impl:136 / _ifft_impl:173): per stage m = first_m, ..., N/2,
// reshape to (N/2m, 2m) blocks, t = w_j * b, (a + t, a - t), w_j = Wt[j N/2m]
// from the (2W, N) table of generator powers, fused by XLA.
//
// Design.  The stages of a (2W, rows, N) limb array run in at most two
// passes (kernels/ntt.py ntt_plan), each reading and writing the array once:
//   tile pass: the stages 2m <= T couple positions inside one tile of T
//     consecutive positions of a row.  A block loads `span` positions (one
//     tile, or several small ones), repacks the 2W sixteen-bit limb planes
//     into W 32-bit word planes in shared memory, loads the tile's
//     twiddles Wt[j N/T], j < T/2 (a contiguous table: every stage below
//     reads a strided subset), runs its stages with a barrier between them
//     and writes back once;
//   column pass: the stages m >= T couple only positions equal mod T.  A
//     block loads the N/T positions {c + k T} of C neighbouring columns c
//     (C int32 in a row of the load, so it stays coalesced), runs the
//     remaining stages in shared memory, its twiddles read from the table
//     in device memory, and writes back once.
// With T = 2^12 and at most 2^12 positions a block, two passes cover
// N <= 2^24; a transform of N <= T is one pass.  Exact arithmetic: the
// values are the per-stage launches' (and the reference's) bit for bit.
//
// Bound on the H100: integer instructions (a Montgomery product a
// butterfly whose twiddle is not 1, an add and a sub each); the array moves
// through device memory twice (2 x 2 x 8W bytes an element), not once a
// stage.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 512;

template <int W>
__device__ __forceinline__ void load_plane(uint32_t* dst, int dst_stride,
                                           int i, const uint32_t* src,
                                           size_t src_stride, size_t pos) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    dst[w * dst_stride + i] =
        __ldg(&src[(2 * w) * src_stride + pos]) |
        (__ldg(&src[(2 * w + 1) * src_stride + pos]) << 16);
}

template <int W>
__device__ __forceinline__ void store_plane(uint32_t* dst, size_t dst_stride,
                                            size_t pos, const uint32_t* src,
                                            int src_stride, int i) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t v = src[w * src_stride + i];
    dst[(2 * w) * dst_stride + pos] = v & 0xffffu;
    dst[(2 * w + 1) * dst_stride + pos] = v >> 16;
  }
}

// (data[i0], data[i1]) = (a + w b, a - w b) in word planes of stride ds
template <int W>
__device__ __forceinline__ void butterfly(uint32_t* data, int ds, int i0,
                                          int i1, const uint32_t w[W],
                                          const fp::Params<W>& P) {
  uint32_t a[W], b[W], r[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    a[k] = data[k * ds + i0];
    b[k] = data[k * ds + i1];
  }
  fp::mont_mul<W>(b, w, b, P);
  fp::add_mod<W>(r, a, b, P);
  fp::sub_mod<W>(a, a, b, P);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    data[k * ds + i0] = r[k];
    data[k * ds + i1] = a[k];
  }
}

// Stages m = m_first, ..., T/2 over the tiles of T positions of x (2W,
// n_flat) (rows of N back to back, T | N).  tw: (2W, .) limb planes of
// stride tw_stride, tw[., j] = Wt[., j N/T] for j < T/2.  A block holds
// `span` positions (a multiple of T).
template <int W>
__global__ void __launch_bounds__(kThreads)
tile_pass_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                 size_t tw_stride, size_t n_flat, int T, int span, int m_first,
                 fp::Params<W> P) {
  extern __shared__ uint32_t sm[];
  uint32_t* data = sm;              // W planes of span words
  uint32_t* tws = sm + W * span;    // W planes of T/2 words
  const size_t base = (size_t)blockIdx.x * span;
  const int len = (int)(n_flat - base < (size_t)span ? n_flat - base : span);
  const int half_t = T / 2;
  for (int j = threadIdx.x; j < half_t; j += blockDim.x)
    load_plane<W>(tws, half_t, j, tw, tw_stride, j);
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    load_plane<W>(data, span, i, x, n_flat, base + i);
  __syncthreads();
  for (int m = m_first; m < T; m *= 2) {
    const int tstep = T / (2 * m);
    for (int b = threadIdx.x; b < len / 2; b += blockDim.x) {
      const int blk = b / m, j = b - blk * m;
      const int i0 = blk * 2 * m + j;
      uint32_t w[W];
#pragma unroll
      for (int k = 0; k < W; ++k) w[k] = tws[k * half_t + j * tstep];
      butterfly<W>(data, span, i0, i0 + m, w, P);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    store_plane<W>(x, n_flat, base + i, data, span, i);
}

// Stages m = m_first, ..., N/2 (m_first >= T) over x (2W, rows * N): block
// (row, g) holds positions c + k T of the C columns c in [g C, g C + C),
// k < N/T; Wt: (2W, N) the whole twiddle table.
template <int W>
__global__ void __launch_bounds__(kThreads)
column_pass_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ Wt,
                   size_t rows, size_t N, int T, int C, long long m_first,
                   fp::Params<W> P) {
  extern __shared__ uint32_t sm[];
  const int K = (int)(N / T);
  const int KC = K * C;
  const int groups = T / C;
  const size_t row = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * C;
  const size_t n_flat = rows * N;
  const size_t base = row * N + c0;
  for (int i = threadIdx.x; i < KC; i += blockDim.x)
    load_plane<W>(sm, KC, i, x, n_flat, base + (size_t)(i / C) * T + i % C);
  __syncthreads();
  for (long long m = m_first; m < (long long)N; m *= 2) {
    const int mk = (int)(m / T);
    const size_t tstep = N / (2 * m);
    for (int b = threadIdx.x; b < KC / 2; b += blockDim.x) {
      const int c = b % C, kk = b / C;
      const int blk = kk / mk, jj = kk - blk * mk;
      const int k0 = blk * 2 * mk + jj;
      const size_t tj = ((size_t)c0 + c + (size_t)jj * T) * tstep;
      uint32_t w[W];
#pragma unroll
      for (int k = 0; k < W; ++k)
        w[k] = __ldg(&Wt[(2 * k) * N + tj]) |
               (__ldg(&Wt[(2 * k + 1) * N + tj]) << 16);
      butterfly<W>(sm, KC, k0 * C + c, (k0 + mk) * C + c, w, P);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < KC; i += blockDim.x)
    store_plane<W>(x, n_flat, base + (size_t)(i / C) * T + i % C, sm, KC, i);
}

int threads_for(long long butterflies) {
  const long long t = (butterflies + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > kThreads ? kThreads : t));
}

template <int W>
int launch_tile(void* x, const void* tw, long long tw_stride, long long n_flat,
                long long T, long long span, long long m_first,
                const uint32_t* field, void* stream) {
  if (T < 2 || span % T || n_flat % T || m_first < 1 || m_first >= T)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(span + T / 2) * W * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tile_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_pass_kernel<W><<<(unsigned)((n_flat + span - 1) / span),
                        threads_for(span / 2), smem, (cudaStream_t)stream>>>(
      (uint32_t*)x, (const uint32_t*)tw, (size_t)tw_stride, (size_t)n_flat,
      (int)T, (int)span, (int)m_first, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

template <int W>
int launch_column(void* x, const void* Wt, long long rows, long long N,
                  long long T, long long C, long long m_first,
                  const uint32_t* field, void* stream) {
  if (T < 2 || N <= T || N % T || T % C || m_first < T || m_first >= N)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N / T) * C * W * 4;
  cudaError_t err = cudaFuncSetAttribute(
      column_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  column_pass_kernel<W><<<(unsigned)(rows * (T / C)),
                          threads_for((N / T) * C / 2), smem,
                          (cudaStream_t)stream>>>(
      (uint32_t*)x, (const uint32_t*)Wt, (size_t)rows, (size_t)N, (int)T,
      (int)C, m_first, fp::params_from<W>(field));
  return (int)cudaGetLastError();
}

}  // namespace

// The tile pass over x (2W, n_flat): stages m_first .. T/2 of every tile of
// T positions, span positions a block; tw the tile's twiddles (limb stride
// tw_stride).
extern "C" int ntt_tile_pass_launch(void* x, const void* tw,
                                    long long tw_stride, long long n_flat,
                                    long long T, long long span,
                                    long long m_first, int words,
                                    const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch_tile, x, tw, tw_stride, n_flat, T, span,
                    m_first, field, stream)
}

// The column pass over x (2W, rows, N): stages m_first .. N/2 (m_first >=
// T), C columns a block; Wt the (2W, N) twiddle table.
extern "C" int ntt_column_pass_launch(void* x, const void* Wt, long long rows,
                                      long long N, long long T, long long C,
                                      long long m_first, int words,
                                      const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch_column, x, Wt, rows, N, T, C, m_first,
                    field, stream)
}
