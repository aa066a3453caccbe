// K13: column placement out[row, c] = values[row, inv[c]] where inv[c] < nv,
// zero where inv[c] == nv (the sentinel of a column no value lands on).
//
// Replaces the JAX reference's place_columns (libiop_tpu/algebra/generic.py:163:
// out[..., positions[k]] = values[..., k], lowered as a gather through the
// inverse placement with a zero sentinel column, fused by XLA).
//
// Design (first, simple): a 2-D grid, x over output columns, y over rows
// (limbs x leading batch; a block row walks further rows when there are
// more than the grid's y extent).  A thread reads its column's entry of the
// memoized inverse map (int32 or int64, on the device) once and then, for
// each of its rows, one int32 of values, or writes 0 for the sentinel.  No
// 64-bit division by the row length.  The zero column of the reference's
// concatenation is never materialized.
//
// Bound on the H100: memory.  The output is written once (4 bytes a limb),
// the values read at most once, the inverse map once per thread (it stays
// in L2: at most a few MB).  No arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename Index>
__global__ void place_columns_kernel(int32_t* __restrict__ out,
                                     const int32_t* __restrict__ values,
                                     const Index* __restrict__ inv,
                                     size_t rows, size_t nv, size_t n) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t k = (size_t)inv[c];
  for (size_t row = blockIdx.y; row < rows; row += gridDim.y)
    out[row * n + c] = k < nv ? values[row * nv + k] : 0;
}

}  // namespace

// values: (rows, nv) int32; inv: (n,) int32 (idx64 == 0) or int64, each
// entry in [0, nv]; out: (rows, n) int32
extern "C" int place_columns_launch(void* out, const void* values,
                                    const void* inv, int idx64, long long rows,
                                    long long nv, long long n, void* stream) {
  const int threads = 256;
  if (rows > 0 && n > 0) {
    const dim3 grid((unsigned)((n + threads - 1) / threads),
                    (unsigned)(rows < 65535 ? rows : 65535));
    if (idx64)
      place_columns_kernel<int64_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
          (int32_t*)out, (const int32_t*)values, (const int64_t*)inv,
          (size_t)rows, (size_t)nv, (size_t)n);
    else
      place_columns_kernel<int32_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
          (int32_t*)out, (const int32_t*)values, (const int32_t*)inv,
          (size_t)rows, (size_t)nv, (size_t)n);
  }
  return (int)cudaGetLastError();
}
