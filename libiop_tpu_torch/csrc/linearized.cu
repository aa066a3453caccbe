// K18: division by, and multiplication by, the linearized vanishing
// polynomial Z of an affine subspace over GF(2^k).
//
// Replaces the JAX reference's divide_by_linearized
// (libiop_tpu/algebra/linearized.py:88) and the additive branch of
// mul_by_vanishing_any (libiop_tpu/algebra/generic.py:207).  Z is sparse:
// x^h plus terms c_i x^(deg_i), deg_i in {0, 1, 2, 4, ..., h/2}, h = 2^m.
// The reference folds the quotient down in chunks of h/2 coefficients.
// Written as a recurrence, the quotient is
//     q_p = f_p + sum_i c_i q_(p + h - deg_i),   h <= p < d,
// (q_t = 0 for t >= d) and the remainder r_p (p < h) the same sum over the
// sources t = p + h - deg_i in [h, d).  Addition is XOR and a product by a
// fixed c_i is GF(2)-linear, so any order of the sums gives the
// reference's bits.
//
// Design.  Division by a small Z (h <= kScanMaxH: the witness's division by
// the input domain's Z, h = 16 over 2^16 coefficients, 8,200 chunks) is a
// blocked scan over the order-h recurrence, four launches:
//   0. nibble tables: word w of c_i * (v x^(4n)) for every term i, nibble
//      position n < 8W and value v < 16, so that a product by c_i is 8W
//      independent table lookups and XORs instead of a 32-step Horner chain;
//   1. the quotient positions [h, d) are cut from the top into S segments of
//      B (a multiple of h/2, B >= h; the bottom one [h, d - (S-1) B) may be
//      shorter).  One block a segment (all but the bottom one) solves the
//      recurrence in shared memory from a zero incoming state, chunk by
//      chunk of h/2 positions (a chunk's positions depend only on positions
//      at least h/2 above), and writes its lowest h values; h more blocks
//      run a segment of zeros from the unit states e_j and write the h x h
//      transition T of B positions (column j);
//   2. one block walks the segments from the top: the true incoming state
//      of segment s + 1 is segment s's lowest h values plus T times the
//      true incoming state of segment s (h^2 products a step);
//   3. one block a segment solves it again from its true incoming state and
//      writes the quotient in place; the bottom block continues over [0, h)
//      with the sources below h masked, which is the remainder.
// Dependent steps: 2 B / (h/2) chunk steps (one barrier each) and S - 1
// carry steps (320 at h = 16, d = 2^16, B = 1024, instead of 8,200 chunks
// one after another).
// The tables live in shared memory when they fit beside the segment
// (n_terms x 8W x 16 x W words: 90 KB for gf192 at h = 16), else in device
// memory.  A larger Z has few chunks: each chunk is one launch of one thread
// a position.  The product is one launch, one thread an output.
//
// Bound on the H100: integer instructions (a product per term and quotient
// position, gf2k.cuh's comb count); the scan does the segment solve twice.
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

constexpr int kMaxTerms = 34;
constexpr int kThreads = 128;
// the carry pass's block (h x G threads, each with Horner products)
constexpr int kCarryThreads = 512;
// the largest Z the scan takes (its carry pass does h^2 products a step)
constexpr long long kScanMaxH = 128;
// the shared memory a block may take (232,448 bytes on sm_90)
constexpr size_t kMaxSmem = 232448;

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

// The scan's shape: S segments of B quotient positions from the top of
// [h, d), chunks of `chunk` positions.
struct Scan {
  long long d, h, chunk, B, S;
};

// words of one term's nibble table
template <int W>
__host__ __device__ constexpr int table_words() {
  return 8 * W * 16 * W;
}

// tab[((q * 8W + n) * 16 + v) * W + w]: word w of c_q * (v x^(4n))
template <int W>
__global__ void nibble_tables_kernel(uint32_t* __restrict__ tab,
                                     const __grid_constant__ Params<W> P) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.z.n_terms * 8 * W * 16) return;
  const int v = idx % 16, n = (idx / 16) % (8 * W), q = idx / (16 * 8 * W);
  uint32_t x[W], c[W];
  gf::set_zero<W>(x);
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == n / 8) x[w] = (uint32_t)v << (4 * (n % 8));
#pragma unroll
  for (int w = 0; w < W; ++w) c[w] = P.z.c[q * gf::kMaxWords + w];
  gf::mul<W>(x, x, c, P.T);
#pragma unroll
  for (int w = 0; w < W; ++w) tab[idx * W + w] = x[w];
}

// word w of c_q * x from q's nibble table (tq = the table + w)
template <int W>
__device__ __forceinline__ uint32_t table_product(const uint32_t* tq,
                                                  const uint32_t x[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int n = 0; n < 8 * W; ++n)
    acc ^= tq[((n * 16) + ((x[n / 8] >> (4 * (n % 8))) & 15u)) * W];
  return acc;
}

// Passes 1 and 3.  final == 0 (pass 1): blocks s < S - 1 solve segment s
// from a zero state and write its lowest h values to lb[s]; blocks
// S - 1 + j solve B zeros from the unit state e_j and write column j of
// Tm.  final == 1 (pass 3): block s solves segment s from st[s] and writes
// it in place; block S - 1 (the bottom one) runs on over [0, h).
// Shared memory: [tables][buf: positions lo .. top + h, W words each].  A
// chunk step gives thread (position, term, word) one word of one product,
// XORed into its position with a shared atomic: one barrier a step.
template <int W>
__global__ void __launch_bounds__(1024)
segment_kernel(uint32_t* __restrict__ work, const uint32_t* __restrict__ tab_g,
               uint32_t* __restrict__ lb, uint32_t* __restrict__ Tm,
               const uint32_t* __restrict__ st, Scan sc, int final,
               int smem_tables, const __grid_constant__ Params<W> P) {
  extern __shared__ uint32_t smem[];
  const int nt = P.z.n_terms;
  const int h = (int)sc.h;
  const long long d = sc.d;
  const int s = blockIdx.x;
  const bool unit = !final && s >= sc.S - 1;  // a transition column
  const long long top = unit ? sc.B : d - s * sc.B;
  const long long lo = unit ? 0 : (s == sc.S - 1 ? (final ? 0 : h)
                                                  : top - sc.B);
  // sources below h are not quotient positions (only the remainder's
  // sources can fall there); the transition's positions are virtual
  const int floor_pos = unit ? 0 : h;
  const int len = (int)(top - lo);

  uint32_t* tab_s = smem;
  uint32_t* buf = smem + (smem_tables ? nt * table_words<W>() : 0);
  const uint32_t* tab = smem_tables ? tab_s : tab_g;
  if (smem_tables) {
#pragma unroll 8
    for (int i = threadIdx.x; i < nt * table_words<W>(); i += blockDim.x)
      tab_s[i] = __ldg(&tab_g[i]);
  }
  // the segment's coefficients (zeros for a transition column)
  for (int i = threadIdx.x; i < len * W; i += blockDim.x) {
    const int p = i % len, w = i / len;
    buf[p * W + w] = unit ? 0u : work[w * d + lo + p];
  }
  // the incoming state: positions [top, top + h)
  for (int i = threadIdx.x; i < h * W; i += blockDim.x) {
    uint32_t v = 0;
    if (unit)
      v = (i / W == s - (sc.S - 1) && i % W == 0) ? 1u : 0u;
    else if (final && s > 0)
      v = st[(long long)s * h * W + i];
    buf[len * W + i] = v;
  }
  __syncthreads();

  // positions [p0, hi) in buffer coordinates, top down
  for (int hi = len; hi > 0;) {
    const int size = (int)sc.chunk < hi ? (int)sc.chunk : hi;
    const int p0 = hi - size;
    for (int idx = threadIdx.x; idx < size * nt * W; idx += blockDim.x) {
      const int w = idx % W, r = idx / W;
      const int q = r % nt, i = r / nt;
      const int src = p0 + i + h - (int)P.z.deg[q];
      if (lo + src >= floor_pos) {
        uint32_t x[W];
#pragma unroll
        for (int k = 0; k < W; ++k) x[k] = buf[src * W + k];
        atomicXor(&buf[(p0 + i) * W + w],
                  table_product<W>(tab + q * table_words<W>() + w, x));
      }
    }
    __syncthreads();
    hi = p0;
  }

  if (final) {
    for (int i = threadIdx.x; i < len * W; i += blockDim.x) {
      const int p = i % len, w = i / len;
      work[w * d + lo + p] = buf[p * W + w];
    }
  } else if (unit) {
    const int j = s - (int)(sc.S - 1);
    for (int i = threadIdx.x; i < h * W; i += blockDim.x)
      Tm[((i / W) * h + j) * W + i % W] = buf[i];
  } else {
    for (int i = threadIdx.x; i < h * W; i += blockDim.x)
      lb[(long long)s * h * W + i] = buf[i];
  }
}

// Pass 2, one block of h x G threads: st[0] = 0, and
// st[s + 1][i] = lb[s][i] + sum_j Tm[i][j] * st[s][j].  Thread (i, g)
// forms the products of j = g, g + G, ...; thread i adds the G partials.
template <int W>
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const uint32_t* __restrict__ Tm, const uint32_t* __restrict__ lb,
             uint32_t* __restrict__ st, long long h, long long S,
             const __grid_constant__ Params<W> P) {
  extern __shared__ uint32_t smem[];
  uint32_t* x = smem;           // the current state, h x W
  uint32_t* part = smem + h * W;  // G x h x W
  const int G = blockDim.x / (int)h;
  const int i = threadIdx.x % (int)h, g = threadIdx.x / (int)h;
  for (long long k = threadIdx.x; k < h * W; k += blockDim.x) {
    x[k] = 0;
    st[k] = 0;
  }
  __syncthreads();
  for (long long s = 0; s + 1 < S; ++s) {
    uint32_t acc[W], a[W], b[W];
    gf::set_zero<W>(acc);
    for (long long j = g; j < h; j += G) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        a[w] = __ldg(&Tm[(i * h + j) * W + w]);
        b[w] = x[j * W + w];
      }
      gf::mul<W>(a, a, b, P.T);
      gf::add<W>(acc, acc, a);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) part[(g * h + i) * W + w] = acc[w];
    __syncthreads();
    if (threadIdx.x < h) {
      const int t = threadIdx.x;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t v = lb[(s * h + t) * W + w];
        for (int k = 0; k < G; ++k) v ^= part[(k * h + t) * W + w];
        x[t * W + w] = v;
        st[((s + 1) * h + t) * W + w] = v;
      }
    }
    __syncthreads();
  }
}

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

int round_threads(long long work) {
  const long long t = (work + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

// the scan's launches; scratch holds the tables, Tm, lb and st
template <int W>
int launch_scan(uint32_t* work, const Params<W>& P, const Scan& sc,
                uint32_t* scratch, cudaStream_t stream, int* launches) {
  const int nt = P.z.n_terms;
  const long long h = sc.h;
  uint32_t* tab = scratch;
  uint32_t* Tm = tab + (size_t)nt * table_words<W>();
  uint32_t* lb = Tm + h * h * W;
  uint32_t* st = lb + (sc.S - 1) * h * W;
  const size_t tab_bytes = (size_t)nt * table_words<W>() * 4;
  // the longest segment is the bottom one with the remainder: B + h
  const size_t seg_bytes = (size_t)(sc.B + 2 * h) * W * 4;
  const int smem_tables = tab_bytes + seg_bytes <= kMaxSmem;
  const size_t smem = seg_bytes + (smem_tables ? tab_bytes : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tab = nt * 8 * W * 16;
  nibble_tables_kernel<W><<<(n_tab + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(tab, P);
  int count = 1;
  const int threads = round_threads(sc.chunk * nt * W);
  if (sc.S > 1) {
    segment_kernel<W><<<(unsigned)(sc.S - 1 + h), threads, smem, stream>>>(
        work, tab, lb, Tm, st, sc, 0, smem_tables, P);
    const int G = (int)(h < kCarryThreads / h ? h : kCarryThreads / h);
    carry_kernel<W><<<1, (unsigned)(h * G), (h + G * h) * W * 4, stream>>>(
        Tm, lb, st, h, sc.S, P);
    count += 2;
  }
  segment_kernel<W><<<(unsigned)sc.S, threads, smem, stream>>>(
      work, tab, lb, Tm, st, sc, 1, smem_tables, P);
  *launches = count + 1;
  return (int)cudaGetLastError();
}

template <int W>
int launch_divide(void* work, long long d, long long h, const void* terms,
                  long long B, void* scratch, const uint32_t* taps,
                  void* stream, int* launches) {
  Params<W> P;
  P.z = *(const Terms*)terms;
  P.T = gf::taps_from(taps);
  *launches = 0;
  if (P.z.n_terms < 0 || P.z.n_terms > kMaxTerms || h < 1)
    return (int)cudaErrorInvalidValue;
  if (P.z.n_terms == 0 || d <= h) return (int)cudaSuccess;
  const long long chunk = h / 2 > 1 ? h / 2 : 1;
  if (B > 0) {  // the scan (the wrapper planned B and sized the scratch)
    if (h > kScanMaxH || B < h || B % chunk) return (int)cudaErrorInvalidValue;
    const Scan sc{d, h, chunk, B, (d - h + B - 1) / B};
    return launch_scan<W>((uint32_t*)work, P, sc, (uint32_t*)scratch,
                          (cudaStream_t)stream, launches);
  }
  long long dmin = 0, dmax = 0;
  for (int q = 0; q < P.z.n_terms; ++q) {
    if (q == 0 || P.z.deg[q] < dmin) dmin = P.z.deg[q];
    if (q == 0 || P.z.deg[q] > dmax) dmax = P.z.deg[q];
  }
  int count = 0;
  for (long long top = d; top > h;) {
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
// x^h in ``terms``): quotient at [h, d), remainder at [0, h).  B > 0 takes
// the blocked scan with segments of B (scratch: the wrapper's
// scan_scratch_words); B = 0 one launch a chunk.
extern "C" int linearized_divide_launch(void* work, long long d, long long h,
                                        const void* terms, long long B,
                                        void* scratch, int words,
                                        const uint32_t* taps, void* stream,
                                        int* launches) {
  GF_DISPATCH_WORDS(words, launch_divide, work, d, h, terms, B, scratch, taps,
                    stream, launches)
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
