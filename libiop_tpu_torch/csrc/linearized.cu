// K18: division by, and multiplication by, the linearized vanishing
// polynomial Z of an affine subspace over GF(2^k).
//
// Replaces the JAX reference's divide_by_linearized
// (libiop_tpu/algebra/linearized.py:88) and the additive branch of
// mul_by_vanishing_any (libiop_tpu/algebra/generic.py:207).  Z is sparse:
// x^h plus terms c_i x^(2^i), i < m = log2 h, and a constant (h = 2^m).
// The reference folds the quotient down in chunks of h/2 coefficients: each
// quotient coefficient at degree t >= h sends c_i * q_t to degree
// t - h + deg_i, more than h/2 below t, so a chunk's contributions never
// land in the chunk itself; per sparse term it does one F.mul and one XOR
// over the chunk.  The product is one F.mul and XOR per term.
//
// Design (first, simple): one thread per target position gathers the XOR
// of c_i * q[pos - off_i] over the sparse terms and writes its position
// once, so no two threads write one word.  The division works in place on
// a copy of the coefficients, whose words at positions >= h are the
// quotient when it ends and whose first h the remainder; its chunks run top
// down, one launch each (the C launcher walks them and reports the count).
// A chunk whose positions times terms fit one block (a small Z: the
// witness's division by the input domain's Z, h = 16, thousands of chunks
// of 8) is instead walked by one block in one launch: one thread per
// (position, term) forms one product into shared memory, one thread per
// position XORs them into its word, and a barrier separates the chunks.
// The product is one launch.  The sparse terms travel in the launch
// parameters.
//
// Bound on the H100: integer instructions (a product per term and position,
// gf2k.cuh); the chunks depend on each other, so a division by a small Z
// over many coefficients is bound by the latency of one product a chunk.
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

constexpr int kMaxTerms = 34;
constexpr int kThreads = 128;
// the largest block that walks a whole division (positions x terms)
constexpr int kLoopThreads = 1024;

// Layout shared with kernels/linearized.py (_Terms, a ctypes.Structure).
struct Terms {
  long long deg[kMaxTerms];
  uint32_t c[kMaxTerms * gf::kMaxWords];
  int n_terms;
};

template <int W>
struct Params {
  Terms z;
  gf::Taps T;
};

// positions p in [lo, lo + span): work[p] ^= sum_i c_i * work[q0 + p - off_i]
// over the terms with 0 <= p - off_i < size, off_i = q0 - h + deg_i
template <int W>
__global__ void divide_chunk_kernel(uint32_t* __restrict__ work, size_t d,
                                    long long h, long long q0, long long size,
                                    long long lo, long long span,
                                    const __grid_constant__ Params<W> P) {
  const long long p = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lo + span) return;
  uint32_t acc[W], x[W], c[W];
  gf::set_zero<W>(acc);
  for (int q = 0; q < P.z.n_terms; ++q) {
    const long long t = p - (q0 - h + P.z.deg[q]);
    if (t < 0 || t >= size) continue;
    gf::load<W>(x, work, d, (size_t)(q0 + t));
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = P.z.c[q * gf::kMaxWords + w];
    gf::mul<W>(x, x, c, P.T);
    gf::add<W>(acc, acc, x);
  }
  gf::load<W>(x, work, d, (size_t)p);
  gf::add<W>(x, x, acc);
  gf::store<W>(work, d, (size_t)p, x);
}

// The whole division by one block: every chunk's span of positions times
// the terms fits the block.  Thread (i, q) = (tid / n_terms, tid % n_terms)
// forms c_q * work[q0 + i - off_q] (or zero) in shared memory; thread i
// then folds the n_terms products into work[lo + i].
template <int W>
__global__ void divide_loop_kernel(uint32_t* __restrict__ work, size_t d,
                                   long long h, long long chunk,
                                   long long dmin, long long dmax,
                                   const __grid_constant__ Params<W> P) {
  extern __shared__ uint32_t prod[];
  const int T = P.z.n_terms;
  const int tid = threadIdx.x, i = tid / T, q = tid % T;
  for (long long top = (long long)d; top > h;) {
    const long long size = chunk < top - h ? chunk : top - h;
    const long long q0 = top - size;
    const long long lo = q0 - h + dmin;
    const long long span = dmax - dmin + size;
    uint32_t x[W];
    gf::set_zero<W>(x);
    if (i < span) {
      const long long t = lo + i - (q0 - h + P.z.deg[q]);
      if (t >= 0 && t < size) {
        uint32_t c[W];
        gf::load<W>(x, work, d, (size_t)(q0 + t));
#pragma unroll
        for (int w = 0; w < W; ++w) c[w] = P.z.c[q * gf::kMaxWords + w];
        gf::mul<W>(x, x, c, P.T);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) prod[tid * W + w] = x[w];
    __syncthreads();
    if (q == 0 && i < span) {
      gf::load<W>(x, work, d, (size_t)(lo + i));
      for (int k = 0; k < T; ++k) {
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] ^= prod[(tid + k) * W + w];
      }
      gf::store<W>(work, d, (size_t)(lo + i), x);
    }
    __syncthreads();
    top -= size;
  }
}

// out[p] = sum_i c_i * f[p - deg_i] over 0 <= p - deg_i < d, p < d + h
template <int W>
__global__ void multiply_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ f, long long d,
                                long long n_out,
                                const __grid_constant__ Params<W> P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_out) return;
  uint32_t acc[W], x[W], c[W];
  gf::set_zero<W>(acc);
  for (int q = 0; q < P.z.n_terms; ++q) {
    const long long t = p - P.z.deg[q];
    if (t < 0 || t >= d) continue;
    gf::load<W>(x, f, (size_t)d, (size_t)t);
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = P.z.c[q * gf::kMaxWords + w];
    gf::mul<W>(x, x, c, P.T);
    gf::add<W>(acc, acc, x);
  }
  gf::store<W>(out, (size_t)n_out, (size_t)p, acc);
}

template <int W>
int launch_divide(void* work, long long d, long long h, const void* terms,
                  const uint32_t* taps, void* stream, int* launches) {
  Params<W> P;
  P.z = *(const Terms*)terms;
  P.T = gf::taps_from(taps);
  if (P.z.n_terms < 0 || P.z.n_terms > kMaxTerms || h < 1)
    return (int)cudaErrorInvalidValue;
  long long dmin = 0, dmax = 0;
  for (int q = 0; q < P.z.n_terms; ++q) {
    if (q == 0 || P.z.deg[q] < dmin) dmin = P.z.deg[q];
    if (q == 0 || P.z.deg[q] > dmax) dmax = P.z.deg[q];
  }
  const long long chunk = h / 2 > 1 ? h / 2 : 1;
  int count = 0;
  const long long loop_threads = (dmax - dmin + chunk) * P.z.n_terms;
  if (P.z.n_terms > 0 && d > h && loop_threads <= kLoopThreads) {
    divide_loop_kernel<W>
        <<<1, (unsigned)loop_threads, loop_threads * W * sizeof(uint32_t),
           (cudaStream_t)stream>>>((uint32_t*)work, (size_t)d, h, chunk, dmin,
                                   dmax, P);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  for (long long top = d; top > h && P.z.n_terms > 0;) {
    const long long size = chunk < top - h ? chunk : top - h;
    const long long q0 = top - size;
    const long long lo = q0 - h + dmin;
    const long long span = dmax - dmin + size;
    divide_chunk_kernel<W>
        <<<(unsigned)((span + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((uint32_t*)work, (size_t)d, h, q0, size,
                                   lo, span, P);
    ++count;
    top -= size;
  }
  *launches = count;
  return (int)cudaGetLastError();
}

template <int W>
int launch_multiply(void* out, const void* f, long long d, long long h,
                    const void* terms, const uint32_t* taps, void* stream,
                    int* launches) {
  Params<W> P;
  P.z = *(const Terms*)terms;
  P.T = gf::taps_from(taps);
  if (P.z.n_terms < 0 || P.z.n_terms > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  const long long n_out = d + h;
  *launches = 0;
  if (n_out > 0) {
    multiply_kernel<W>
        <<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)f, d,
                                   n_out, P);
    *launches = 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// work: (W, d) coefficients, divided in place by Z (degree h, terms below
// x^h in ``terms``): quotient at [h, d), remainder at [0, h)
extern "C" int linearized_divide_launch(void* work, long long d, long long h,
                                        const void* terms, int words,
                                        const uint32_t* taps, void* stream,
                                        int* launches) {
  GF_DISPATCH_WORDS(words, launch_divide, work, d, h, terms, taps, stream,
                    launches)
}

// out: (W, d + h) = Z * f for f: (W, d), with every term of Z in ``terms``
extern "C" int linearized_multiply_launch(void* out, const void* f,
                                          long long d, long long h,
                                          const void* terms, int words,
                                          const uint32_t* taps, void* stream,
                                          int* launches) {
  GF_DISPATCH_WORDS(words, launch_multiply, out, f, d, h, terms, taps, stream,
                    launches)
}
