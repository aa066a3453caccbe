// K23: the data movement of the four-step (Bailey) NTT, one kernel template
// with four launch shapes.
//
// Replaces the reshapes, transposes and twiddle products that the JAX
// reference's ShardedNTT (libiop_tpu/parallel/shard_ntt.py:40, its
// _local_fn:70-90 and run:104-110) leaves to XLA inside shard_map.  N = R C,
// the input x[j1 + R j2] viewed as a grid [j2, j1], shard s of D holding
// the j1 columns [s R/D, (s+1) R/D).  The C- and R-point NTTs between the
// passes are K2's stages (csrc/ntt.cu) over bit-reversed rows.  Layouts are
// the port's limbs-first int32 arrays ((2W, ...) of 16-bit limbs); B is the
// batch of codewords, RD = R/D, CD = C/D:
//
//  PROLOGUE  in  x (2W, B, d) coefficients, table = shift powers (2W, N) or
//                null; out (2W, B, RD, C):
//                out[b, i, t] = x[b, j] * sp[j], j = s RD + i + R rev_C(t),
//                zero for j >= d (the zero padding to N).
//  TWIDDLE   in  (2W, B, RD, C), table = generator powers W (2W, N);
//            out (D, 2W, B, RD, CD), each destination's chunk contiguous:
//                out[t, b, i, k] = in[b, i, t CD + k] * W[(j1 k2) mod N],
//                j1 = s RD + i, k2 = t CD + k.
//  UNPACK    in  (D, 2W, B, RD, CD) received, source shard first;
//            out (2W, B, CD, R): out[b, k, t] = in[src, b, i, k] with
//                src RD + i = rev_R(t).
//  EPILOGUE  in  (D, 2W, B, CD, R) gathered; out (2W, B, N):
//                out[b, k1 C + s CD + k] = in[s, b, k, k1].
//
// Design (first, simple): a block of 32 x 8 threads owns a 32 x 32 tile of
// the pass's (x, y) plane, x the input's contiguous axis, each thread four
// elements (y, y + 8, y + 16, y + 24).  A thread loads its elements' limbs
// (neighbouring threads on neighbouring words) and applies the Montgomery
// product of PROLOGUE and TWIDDLE in registers.  The transposing passes
// (PROLOGUE, UNPACK, EPILOGUE) then stage each 32-bit word plane of the tile
// through a 32 x 33 shared array, so that the stores too run along the
// output's contiguous axis; TWIDDLE keeps the input's order and stores from
// registers.
//
// Bound on the H100: memory.  Each pass reads and writes the array once
// (PROLOGUE and TWIDDLE also read a table entry an element) against at most
// one Montgomery product an element; the table reads of TWIDDLE stride by
// j1 and are its uncoalesced part.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Mode { kPrologue = 0, kTwiddle = 1, kUnpack = 2, kEpilogue = 3 };

struct Shape {
  long long B, D, R, C, N, RD, CD, d, s;
  int logR, logC;
  long long nx, ny, tiles_x;      // the pass's (x, y) plane, tiles along x
  long long in_plane, out_plane;  // limb strides of input and output
};

__device__ __forceinline__ long long rev(long long v, int bits) {
  return bits == 0 ? 0 : (long long)(__brev((unsigned)v) >> (32 - bits));
}

// Element (x, y) of slab z: its input index (-1: a padded zero) and its
// table index (-1: no product).  An array with a leading shard axis keeps
// shard q's block 2W limb planes (2W * plane entries) after shard q-1's.
template <int W, int MODE>
__device__ __forceinline__ void source(const Shape& S, long long z,
                                       long long x, long long y,
                                       long long& idx, long long& tab) {
  tab = -1;
  if (MODE == kPrologue) {  // z = b, x = i, y = t
    const long long j = S.s * S.RD + x + S.R * rev(y, S.logC);
    idx = j < S.d ? z * S.d + j : -1;
    tab = j;
  } else if (MODE == kTwiddle) {  // z = (t, b), x = k, y = i
    const long long t = z / S.B, b = z - t * S.B;
    idx = (b * S.RD + y) * S.C + t * S.CD + x;
    tab = ((S.s * S.RD + y) * (t * S.CD + x)) % S.N;
  } else if (MODE == kUnpack) {  // z = b, x = k, y = t
    const long long j1 = rev(y, S.logR);
    const long long src = j1 / S.RD, i = j1 - src * S.RD;
    idx = src * 2 * W * S.in_plane + (z * S.RD + i) * S.CD + x;
  } else {  // kEpilogue: z = (s, b), x = k1, y = k
    const long long s = z / S.B, b = z - s * S.B;
    idx = s * 2 * W * S.in_plane + (b * S.CD + y) * S.R + x;
  }
}

// Element (x, y) of slab z: its output index.
template <int W, int MODE>
__device__ __forceinline__ long long dest(const Shape& S, long long z,
                                          long long x, long long y) {
  if (MODE == kPrologue) return (z * S.RD + x) * S.C + y;
  if (MODE == kTwiddle) {
    const long long t = z / S.B, b = z - t * S.B;
    return t * 2 * W * S.out_plane + (b * S.RD + y) * S.CD + x;
  }
  if (MODE == kUnpack) return (z * S.CD + x) * S.R + y;
  const long long s = z / S.B, b = z - s * S.B;  // kEpilogue
  return b * S.N + x * S.C + s * S.CD + y;
}

template <int W, int MODE>
__global__ void four_step_kernel(uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ in,
                                 const uint32_t* __restrict__ table, Shape S,
                                 fp::Params<W> P) {
  __shared__ uint32_t tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long z = blockIdx.y;
  const long long X0 = (blockIdx.x % S.tiles_x) * 32;
  const long long Y0 = (blockIdx.x / S.tiles_x) * 32;
  uint32_t v[4][W];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long x = X0 + tx, y = Y0 + ty + 8 * q;
    fp::set_zero<W>(v[q]);
    if (x >= S.nx || y >= S.ny) continue;
    long long idx, tab;
    source<W, MODE>(S, z, x, y, idx, tab);
    if (idx < 0) continue;
    fp::load<W>(v[q], in, S.in_plane, idx);
    if (tab >= 0 && table != nullptr) {
      uint32_t w[W];
      fp::load<W>(w, table, S.N, tab);
      fp::mont_mul<W>(v[q], v[q], w, P);
    }
  }
  if (MODE == kTwiddle) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long x = X0 + tx, y = Y0 + ty + 8 * q;
      if (x < S.nx && y < S.ny)
        fp::store<W>(out, S.out_plane, dest<W, MODE>(S, z, x, y), v[q]);
    }
    return;
  }
  // transpose through shared memory, one 32-bit word plane at a time: the
  // thread that loaded (x, y) leaves it at tile[y - Y0][x - X0]; the thread
  // (tx, ty) stores (X0 + ty + 8q, Y0 + tx)
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[ty + 8 * q][tx] = v[q][w];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long x = X0 + ty + 8 * q, y = Y0 + tx;
      if (x < S.nx && y < S.ny) {
        const uint32_t word = tile[tx][ty + 8 * q];
        const long long o = dest<W, MODE>(S, z, x, y);
        out[(2 * w) * S.out_plane + o] = word & 0xffffu;
        out[(2 * w + 1) * S.out_plane + o] = word >> 16;
      }
    }
    __syncthreads();
  }
}

template <int W>
int launch(int mode, void* out, const void* in, const void* table,
           long long B, long long D, long long R, long long C, long long d,
           long long s, const uint32_t* field, void* stream) {
  Shape S;
  S.B = B; S.D = D; S.R = R; S.C = C; S.N = R * C;
  S.RD = R / D; S.CD = C / D; S.d = d; S.s = s;
  S.logR = 0;
  while ((1LL << S.logR) < R) ++S.logR;
  S.logC = 0;
  while ((1LL << S.logC) < C) ++S.logC;
  long long slabs;
  switch (mode) {
    case kPrologue:  // (B, d) -> (B, RD, C)
      S.nx = S.RD; S.ny = C; slabs = B;
      S.in_plane = B * d; S.out_plane = B * S.RD * C;
      break;
    case kTwiddle:  // (B, RD, C) -> (D, B, RD, CD)
      S.nx = S.CD; S.ny = S.RD; slabs = D * B;
      S.in_plane = B * S.RD * C; S.out_plane = B * S.RD * S.CD;
      break;
    case kUnpack:  // (D, B, RD, CD) -> (B, CD, R)
      S.nx = S.CD; S.ny = R; slabs = B;
      S.in_plane = B * S.RD * S.CD; S.out_plane = B * S.CD * R;
      break;
    case kEpilogue:  // (D, B, CD, R) -> (B, N)
      S.nx = R; S.ny = S.CD; slabs = D * B;
      S.in_plane = B * S.CD * R; S.out_plane = B * S.N;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (D < 1 || R % D || C % D || slabs > 65535) return (int)cudaErrorInvalidValue;
  S.tiles_x = (S.nx + 31) / 32;
  const long long tiles = S.tiles_x * ((S.ny + 31) / 32);
  if (tiles == 0 || slabs == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)tiles, (unsigned)slabs), block(32, 8);
  const fp::Params<W> P = fp::params_from<W>(field);
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* i = (const uint32_t*)in;
  const uint32_t* t = (const uint32_t*)table;
  switch (mode) {
    case kPrologue:
      four_step_kernel<W, kPrologue><<<grid, block, 0, st>>>(o, i, t, S, P);
      break;
    case kTwiddle:
      four_step_kernel<W, kTwiddle><<<grid, block, 0, st>>>(o, i, t, S, P);
      break;
    case kUnpack:
      four_step_kernel<W, kUnpack><<<grid, block, 0, st>>>(o, i, t, S, P);
      break;
    default:
      four_step_kernel<W, kEpilogue><<<grid, block, 0, st>>>(o, i, t, S, P);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 prologue, 1 twiddle and pack, 2 unpack, 3 epilogue (shapes
// above); table: the shift powers (prologue; null for shift 1) or the
// generator powers (twiddle), (2W, R C); d: the coefficient count
// (prologue); s: this shard (prologue, twiddle)
extern "C" int four_step_launch(int mode, void* out, const void* in,
                                const void* table, long long B, long long D,
                                long long R, long long C, long long d,
                                long long s, int words, const uint32_t* field,
                                void* stream) {
  FP_DISPATCH_WORDS(words, launch, mode, out, in, table, B, D, R, C, d, s,
                    field, stream)
}
