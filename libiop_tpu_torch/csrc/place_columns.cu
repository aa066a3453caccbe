// K13: column placement out[row, c] = values[row, inv[c]] where inv[c] < nv,
// zero where inv[c] == nv (the sentinel of a column no value lands on).
//
// Replaces the JAX reference's place_columns (libiop_tpu/algebra/generic.py:163:
// out[..., positions[k]] = values[..., k], lowered as a gather through the
// inverse placement with a zero sentinel column, fused by XLA).
//
// Bound on the H100: memory, and at the paths' sizes latency.  The output is
// written once (4 bytes a limb), each placed value read once, the inverse
// map once; no arithmetic.  At 2^16 columns of 12 or 16 limb rows the whole
// call moves 6-8 MB, about 2-2.6 us at 3.35 TB/s: a launch and one or two
// trips to memory are most of the time, so the design keeps every load a
// thread makes independent and in flight at once, and fills the 132 SMs.
//
// Design: a thread owns kCols = 4 adjacent output columns over kRows = 4
// rows (limb planes; grid.y walks the row chunks, so 2^16 columns of 12
// rows give 128 x 3 blocks of 128 threads).  It reads its 4 map entries
// with one 16-byte load (two for an int64 map), issues its 16 gathered
// 4-byte loads of values at once (none for the sentinel: a zero), and
// writes each row's 4 columns with one 16-byte store.  The gathers go
// where the map sends them; the map reads and the stores are coalesced
// 16-byte accesses.  When n is not a multiple of 4
// or the map or the output is not 16-byte aligned (a map taken from an
// offset view), the same threads take the scalar path: 4-byte map reads
// and stores, the tail columns masked.  The zero column of the reference's
// concatenation is never materialized.  What the gathers cost depends on
// the map: the paths' maps (the identity, lincheck's subgroup reindex) are
// nearly sequential, so a warp's gathers share sectors; a random
// permutation takes about twice as long, each 4-byte limb it gathers
// costing a 32-byte sector of its own (12 or 16 a column).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kRows = 4;

template <typename Index, bool kVec>
__device__ __forceinline__ void load_map(const Index* __restrict__ inv,
                                         size_t c0, size_t n, size_t nv,
                                         size_t (&k)[kCols]) {
  if (kVec) {
    if (sizeof(Index) == 4) {
      const int4 m = *reinterpret_cast<const int4*>(inv + c0);
      k[0] = (uint32_t)m.x; k[1] = (uint32_t)m.y;
      k[2] = (uint32_t)m.z; k[3] = (uint32_t)m.w;
    } else {
      const longlong2 a = *reinterpret_cast<const longlong2*>(inv + c0);
      const longlong2 b = *reinterpret_cast<const longlong2*>(inv + c0 + 2);
      k[0] = (size_t)a.x; k[1] = (size_t)a.y;
      k[2] = (size_t)b.x; k[3] = (size_t)b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      k[j] = c0 + j < n ? (size_t)inv[c0 + j] : nv;
  }
}

template <typename Index, bool kVec>
__global__ void __launch_bounds__(kThreads)
    place_columns_kernel(int32_t* __restrict__ out,
                         const int32_t* __restrict__ values,
                         const Index* __restrict__ inv, size_t rows,
                         size_t nv, size_t n) {
  const size_t c0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= n) return;
  size_t k[kCols];
  load_map<Index, kVec>(inv, c0, n, nv, k);
  for (size_t row0 = (size_t)blockIdx.y * kRows; row0 < rows;
       row0 += (size_t)gridDim.y * kRows) {
    int32_t v[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[r][j] = row0 + r < rows && k[j] < nv
                      ? __ldg(values + (row0 + r) * nv + k[j])
                      : 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= rows) break;
      int32_t* o = out + (row0 + r) * n + c0;
      if (kVec) {
        *reinterpret_cast<int4*>(o) =
            make_int4(v[r][0], v[r][1], v[r][2], v[r][3]);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + j < n) o[j] = v[r][j];
      }
    }
  }
}

template <typename Index>
void launch(int32_t* out, const int32_t* values, const Index* inv,
            size_t rows, size_t nv, size_t n, cudaStream_t stream) {
  const size_t quads = (n + kCols - 1) / kCols;
  const size_t chunks = (rows + kRows - 1) / kRows;
  const dim3 grid((unsigned)((quads + kThreads - 1) / kThreads),
                  (unsigned)(chunks < 65535 ? chunks : 65535));
  const bool vec = n % kCols == 0 && (uintptr_t)inv % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec)
    place_columns_kernel<Index, true><<<grid, kThreads, 0, stream>>>(
        out, values, inv, rows, nv, n);
  else
    place_columns_kernel<Index, false><<<grid, kThreads, 0, stream>>>(
        out, values, inv, rows, nv, n);
}

}  // namespace

// values: (rows, nv) int32; inv: (n,) int32 (idx64 == 0) or int64, each
// entry in [0, nv]; out: (rows, n) int32
extern "C" int place_columns_launch(void* out, const void* values,
                                    const void* inv, int idx64, long long rows,
                                    long long nv, long long n, void* stream) {
  if (rows > 0 && n > 0) {
    if (idx64)
      launch<int64_t>((int32_t*)out, (const int32_t*)values,
                      (const int64_t*)inv, (size_t)rows, (size_t)nv,
                      (size_t)n, (cudaStream_t)stream);
    else
      launch<int32_t>((int32_t*)out, (const int32_t*)values,
                      (const int32_t*)inv, (size_t)rows, (size_t)nv,
                      (size_t)n, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
