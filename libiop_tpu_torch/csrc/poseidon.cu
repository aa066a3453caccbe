// K9: batched Poseidon sponge over n items (Merkle leaves or tree nodes).
//
// Replaces the JAX reference's BatchedPoseidon (libiop_tpu/bcs/poseidon.py:263:
// permute:317, hash_columns:348, two_to_one_columns:375), which XLA ran as
// three lax.scans of full-batch field ops per permutation, and the leaf and
// level hashing around it (PoseidonHashing.leaf_hash_batch:496 and
// tree_layer:512).
//
// Item i is a sponge over k field elements: element e is column
// in_off + e*in_estride + i*in_istride of the (2W, *) limb array `in`.  The
// elements are added into state[0:rate] in rate-sized chunks with a
// permutation between chunks, then one final permutation; state[0] goes to
// column out_off + i of `out`.  A Merkle leaf is the sponge over its coset
// column (zk: its salt element appended); a tree node is the sponge over
// (left, right), the reference's two-to-one (state[0..1] SET from zero, one
// permutation).  The wrapper launches once for a tree's leaves and once per
// level, into a (2W, 2n) heap whose column 1 is the root.
//
// The permutation (poseidon.tcc:241-297): per round, add the round keys to
// every lane, S-box x^alpha (square and multiply over the bits of alpha) on
// every lane in the full rounds and on the last lane in the partial rounds,
// then mix: per output lane t wide products with the MDS row summed lazily
// and one Montgomery reduction, or the add-only near-MDS forms for t = 3
// ([s0+s2, s0+s1, s1+s2]) and t = 4 (sum - s_i).
//
// Design (first, simple): one thread per item holds its t-lane state (t W
// words, in registers) and runs every round.  The round keys and the MDS
// matrix (Montgomery form) live in __constant__ memory, uploaded by the
// launcher only when the parameter set (its key) changes: every thread of a
// warp reads the same key at the same time, so the constant cache
// broadcasts it.  Instantiated for W = 6 and W = 8 and t = 3, 4.
//
// Bound on the H100: integer instructions.  A permutation of the default
// alt_bn128 preset (8 full + 56 partial rounds, alpha 5, full MDS) does
// 240 S-box products (8 x 3 x 3 + 56 x 3) and 64 mixes of 9 wide products
// and 3 reductions (a wide product or a reduction is about half a product),
// the high-alpha one (8 + 29, alpha 17, near-MDS) 265 products, against 8W
// bytes read per element and 8W written per item.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kMaxT = 4;
constexpr int kMaxRounds = 160;

// Layout shared with kernels/poseidon.py (pack_consts).
template <int W>
struct PoseidonConsts {
  int t, rate, alpha, full_rounds, partial_rounds, near_mds;
  uint32_t rc[kMaxRounds * kMaxT * W];  // round r, lane i: element r*t + i
  uint32_t mds[kMaxT * kMaxT * W];      // row i, column j: element i*t + j
};

__constant__ PoseidonConsts<6> g_consts6;
__constant__ PoseidonConsts<8> g_consts8;

template <int W>
__device__ __forceinline__ const PoseidonConsts<W>& consts();
template <>
__device__ __forceinline__ const PoseidonConsts<6>& consts<6>() {
  return g_consts6;
}
template <>
__device__ __forceinline__ const PoseidonConsts<8>& consts<8>() {
  return g_consts8;
}

// x <- x^alpha, square and multiply from the highest bit of alpha down.
template <int W>
HD void sbox(uint32_t x[W], int alpha, const fp::Params<W>& P) {
  int hb = 0;
  while ((alpha >> (hb + 1)) != 0) ++hb;
  uint32_t acc[W];
  fp::copy<W>(acc, x);
  for (int b = hb - 1; b >= 0; --b) {
    fp::mont_mul<W>(acc, acc, acc, P);
    if ((alpha >> b) & 1) fp::mont_mul<W>(acc, acc, x, P);
  }
  fp::copy<W>(x, acc);
}

template <int W, int T>
HD void mix(uint32_t s[T][W], const PoseidonConsts<W>& c,
            const fp::Params<W>& P) {
  if (c.near_mds && T == 3) {
    uint32_t s0[W];
    fp::copy<W>(s0, s[0]);
    fp::add_mod<W>(s[0], s0, s[2], P);
    fp::add_mod<W>(s[2], s[1], s[2], P);
    fp::add_mod<W>(s[1], s0, s[1], P);
  } else if (c.near_mds && T == 4) {
    uint32_t tot[W], u[W];
    fp::add_mod<W>(tot, s[0], s[1], P);
    fp::add_mod<W>(u, s[2], s[3 % T], P);
    fp::add_mod<W>(tot, tot, u, P);
#pragma unroll
    for (int i = 0; i < T; ++i) fp::sub_mod<W>(s[i], tot, s[i], P);
  } else {
    // row i: t wide products summed lazily (< t p^2 < p 2^(32W), as the
    // launcher checks 4p < 2^(32W)), one Montgomery reduction
    uint32_t out[T][W], acc[2 * W + 1];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
#pragma unroll
      for (int j = 0; j < T; ++j)
        fp::mul_wide_acc<W>(acc, &c.mds[(i * T + j) * W], s[j]);
      fp::redc_wide<W>(out[i], acc, P);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) fp::copy<W>(s[i], out[i]);
  }
}

template <int W, int T>
HD void permute(uint32_t s[T][W], const PoseidonConsts<W>& c,
                const fp::Params<W>& P) {
  const int half = c.full_rounds / 2;
  const int rounds = c.full_rounds + c.partial_rounds;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int i = 0; i < T; ++i)
      fp::add_mod<W>(s[i], s[i], &c.rc[(r * T + i) * W], P);
    if (r >= half && r < half + c.partial_rounds) {
      sbox<W>(s[T - 1], c.alpha, P);
    } else {
#pragma unroll
      for (int i = 0; i < T; ++i) sbox<W>(s[i], c.alpha, P);
    }
    mix<W, T>(s, c, P);
  }
}

// The sponge over item i's k elements (see the header); returns state[0].
template <int W, int T>
HD void sponge(uint32_t digest[W], const uint32_t* in, size_t in_stride,
               size_t in_off, size_t in_estride, size_t in_istride, size_t i,
               int k, const PoseidonConsts<W>& c, const fp::Params<W>& P) {
  uint32_t s[T][W];
#pragma unroll
  for (int j = 0; j < T; ++j) fp::set_zero<W>(s[j]);
  for (int start = 0; start < k; start += c.rate) {
    if (start > 0) permute<W, T>(s, c, P);
#pragma unroll
    for (int e = 0; e < T; ++e) {
      if (e < c.rate && start + e < k) {
        uint32_t x[W];
        fp::load<W>(x, in, in_stride,
                    in_off + (size_t)(start + e) * in_estride + i * in_istride);
        fp::add_mod<W>(s[e], s[e], x, P);
      }
    }
  }
  permute<W, T>(s, c, P);
  fp::copy<W>(digest, s[0]);
}

template <int W, int T>
__global__ void poseidon_kernel(uint32_t* __restrict__ out, size_t out_stride,
                                size_t out_off, const uint32_t* in,
                                size_t in_stride, size_t in_off,
                                size_t in_estride, size_t in_istride,
                                size_t n, int k, fp::Params<W> P) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t d[W];
  sponge<W, T>(d, in, in_stride, in_off, in_estride, in_istride, i, k,
               consts<W>(), P);
  fp::store<W>(out, out_stride, out_off + i, d);
}

template <int W>
cudaError_t upload(const uint32_t* block, cudaStream_t stream) {
  if constexpr (W == 6)
    return cudaMemcpyToSymbolAsync(g_consts6, block, sizeof(g_consts6), 0,
                                   cudaMemcpyHostToDevice, stream);
  else
    return cudaMemcpyToSymbolAsync(g_consts8, block, sizeof(g_consts8), 0,
                                   cudaMemcpyHostToDevice, stream);
}

template <int W>
int launch(void* out, long long out_stride, long long out_off, const void* in,
           long long in_stride, long long in_off, long long in_estride,
           long long in_istride, long long n, int k, const uint32_t* block,
           long long key, const uint32_t* field, void* stream) {
  static long long loaded_key = 0;  // the parameter set in constant memory
  const int t = (int)block[0], rate = (int)block[1];
  const int rounds = (int)(block[3] + block[4]);
  // the lazy MDS sum needs t p^2 < p 2^(32W): 4p < 2^(32W)
  if (t < 3 || t > kMaxT || rate < 2 || rate >= t || rounds > kMaxRounds ||
      k < 1 || (field[W - 1] >> 30) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key != loaded_key) {
    const cudaError_t err = upload<W>(block, s);
    if (err != cudaSuccess) return (int)err;
    loaded_key = key;
  }
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const fp::Params<W> P = fp::params_from<W>(field);
  if (n > 0) {
    if (t == 3)
      poseidon_kernel<W, 3><<<blocks, threads, 0, s>>>(
          (uint32_t*)out, (size_t)out_stride, (size_t)out_off,
          (const uint32_t*)in, (size_t)in_stride, (size_t)in_off,
          (size_t)in_estride, (size_t)in_istride, (size_t)n, k, P);
    else
      poseidon_kernel<W, 4><<<blocks, threads, 0, s>>>(
          (uint32_t*)out, (size_t)out_stride, (size_t)out_off,
          (const uint32_t*)in, (size_t)in_stride, (size_t)in_off,
          (size_t)in_estride, (size_t)in_istride, (size_t)n, k, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int poseidon_launch(void* out, long long out_stride,
                               long long out_off, const void* in,
                               long long in_stride, long long in_off,
                               long long in_estride, long long in_istride,
                               long long n, int k, const uint32_t* block,
                               long long key, int words, const uint32_t* field,
                               void* stream) {
  FP_DISPATCH_WORDS(words, launch, out, out_stride, out_off, in, in_stride,
                    in_off, in_estride, in_istride, n, k, block, key, field,
                    stream)
}
