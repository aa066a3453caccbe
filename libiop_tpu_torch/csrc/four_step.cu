// K23: the data movement of the four-step (Bailey) NTT, four launch shapes
// of two kernels: four_step_kernel (PROLOGUE, TWIDDLE: with the Montgomery
// product) and move_kernel (UNPACK, EPILOGUE: limb-plane permutations).
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
// Design of PROLOGUE and TWIDDLE: a block of 32 x 8 threads owns a 32 x 32
// tile of the pass's (x, y) plane, x the input's contiguous axis, each
// thread four elements (y, y + 8, y + 16, y + 24).  A thread loads its
// elements' limbs (neighbouring threads on neighbouring words) and applies
// the Montgomery product in registers.  PROLOGUE then stages each 32-bit
// word plane of the tile through a 32 x 33 shared array, so that the stores
// too run along the output's contiguous axis; TWIDDLE keeps the input's
// order and stores from registers.  Bound on the H100: memory.  Each reads
// and writes its array once and a table entry an element against one
// Montgomery product an element; the table reads of TWIDDLE stride by j1
// and are its uncoalesced part.
//
// Design of UNPACK and EPILOGUE (move_kernel): both are pure permutations
// that apply one index map to every limb plane, so they move the int32
// limbs as they are (no packing of two limbs into a word, no split on
// store).  Each is a transpose of (P, Q) matrices, one a limb plane and
// batch entry (and source shard, for EPILOGUE), with P the output's and Q
// the input's contiguous axis:
//   UNPACK    plane (l, b): input row p = t is the bit-reversed source row
//             j1 = rev_R(t) (CD contiguous words at in[src, l, b, i]),
//             q = k; output row q at out[l, b, k], contiguous over t.
//   EPILOGUE  plane (s, l, b): input row p = k at in[s, l, b, k] (R words),
//             q = k1; output row q at out[l, b, k1 C + s CD], contiguous
//             over k.
// Bound on the H100: memory (each limb read and written once), and at the
// sharded prove's sizes (3-6 MB a pass) latency: the first design walked
// 2W word planes through one shared array with two barriers each and
// launched 64-256 blocks.  Here the limb plane is on the grid (blockIdx.y),
// so one block moves one 32 x 32 tile of one plane with one barrier: 768
// blocks for the largest UNPACK and 3,072 for its EPILOGUE at 12 limbs.
// A block of 256 threads reads the tile's 32 input rows with one 16-byte
// load a thread (8 threads a 128-byte row segment), leaves them in a
// 32 x 33 shared array, and writes the 32 output rows with one 16-byte
// store a thread; the padded row keeps both shared passes free of bank
// conflicts.  Shapes with CD or R below 4 or not a multiple of it (the
// sharded prove's small transforms reach CD = 1 and R = D), or buffers not
// 16-byte aligned, take the same tiles with 4-byte accesses.
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
// table index (-1: no product).
template <int W, int MODE>
__device__ __forceinline__ void source(const Shape& S, long long z,
                                       long long x, long long y,
                                       long long& idx, long long& tab) {
  tab = -1;
  if (MODE == kPrologue) {  // z = b, x = i, y = t
    const long long j = S.s * S.RD + x + S.R * rev(y, S.logC);
    idx = j < S.d ? z * S.d + j : -1;
    tab = j;
  } else {  // kTwiddle: z = (t, b), x = k, y = i
    const long long t = z / S.B, b = z - t * S.B;
    idx = (b * S.RD + y) * S.C + t * S.CD + x;
    tab = ((S.s * S.RD + y) * (t * S.CD + x)) % S.N;
  }
}

// Element (x, y) of slab z: its output index.
template <int W, int MODE>
__device__ __forceinline__ long long dest(const Shape& S, long long z,
                                          long long x, long long y) {
  if (MODE == kPrologue) return (z * S.RD + x) * S.C + y;
  const long long t = z / S.B, b = z - t * S.B;  // kTwiddle
  return t * 2 * W * S.out_plane + (b * S.RD + y) * S.CD + x;
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
  // PROLOGUE: transpose through shared memory, one 32-bit word plane at a
  // time: the thread that loaded (x, y) leaves it at tile[y - Y0][x - X0];
  // the thread (tx, ty) stores (X0 + ty + 8q, Y0 + tx)
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

// The (P, Q) matrices of UNPACK and EPILOGUE (see the design note): nz of
// them, P x Q each, tiles_q tiles of 32 along Q.
struct Move {
  long long B, L, R, C, N, RD, CD, shard;  // shard: one source shard's words
  int logR;
  long long np, nq, nz, tiles_q;
};

// Start of input row p of matrix z (its Q words are contiguous).
template <int MODE>
__device__ __forceinline__ long long in_row(const Move& M, long long z,
                                            long long p) {
  if (MODE == kUnpack) {  // z = (l, b), p = t
    const long long j1 = rev(p, M.logR);
    const long long src = j1 / M.RD, i = j1 - src * M.RD;
    return src * M.shard + (z * M.RD + i) * M.CD;
  }
  return (z * M.CD + p) * M.R;  // kEpilogue: z = (s, l, b), p = k
}

// Start of output row q of matrix z (its P words are contiguous).
template <int MODE>
__device__ __forceinline__ long long out_row(const Move& M, long long z,
                                             long long q) {
  if (MODE == kUnpack) return (z * M.CD + q) * M.R;  // q = k
  const long long lb = M.L * M.B;                    // q = k1
  const long long s = z / lb;
  return (z - s * lb) * M.N + q * M.C + s * M.CD;
}

template <int MODE, bool kVec>
__global__ void __launch_bounds__(256)
    move_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in,
                Move M) {
  __shared__ uint32_t tile[32][33];
  const int tid = threadIdx.x;
  const long long P0 = (blockIdx.x / M.tiles_q) * 32;
  const long long Q0 = (blockIdx.x % M.tiles_q) * 32;
  for (long long z = blockIdx.y; z < M.nz; z += gridDim.y) {
    if (kVec) {  // thread: input row tid / 8, words 4 (tid % 8) + 0..3
      const int r = tid >> 3, c = (tid & 7) * 4;
      const long long p = P0 + r, q = Q0 + c;
      if (p < M.np && q < M.nq) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(in + in_row<MODE>(M, z, p) + q);
        tile[r][c] = v.x; tile[r][c + 1] = v.y;
        tile[r][c + 2] = v.z; tile[r][c + 3] = v.w;
      }
      __syncthreads();
      // thread: output row tid / 8, words 4 (tid % 8) + 0..3
      const long long qo = Q0 + r, po = P0 + c;
      if (qo < M.nq && po < M.np)
        *reinterpret_cast<uint4*>(out + out_row<MODE>(M, z, qo) + po) =
            make_uint4(tile[c][r], tile[c + 1][r], tile[c + 2][r],
                       tile[c + 3][r]);
    } else {  // 32 x 8 threads, 4 elements each
      const int tx = tid & 31, ty = tid >> 5;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long p = P0 + ty + 8 * k, q = Q0 + tx;
        if (p < M.np && q < M.nq)
          tile[ty + 8 * k][tx] = in[in_row<MODE>(M, z, p) + q];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long q = Q0 + ty + 8 * k, p = P0 + tx;
        if (q < M.nq && p < M.np)
          out[out_row<MODE>(M, z, q) + p] = tile[tx][ty + 8 * k];
      }
    }
    __syncthreads();
  }
}

int launch_move(int mode, void* out, const void* in, long long B,
                long long D, long long R, long long C, long long L,
                void* stream) {
  if (D < 1 || R % D || C % D || L < 1) return (int)cudaErrorInvalidValue;
  Move M;
  M.B = B; M.L = L; M.R = R; M.C = C; M.N = R * C;
  M.RD = R / D; M.CD = C / D; M.shard = L * B * M.RD * M.CD;
  M.logR = 0;
  while ((1LL << M.logR) < R) ++M.logR;
  if (mode == kUnpack) {  // (D, L, B, RD, CD) -> (L, B, CD, R)
    M.np = R; M.nq = M.CD; M.nz = L * B;
  } else {  // (D, L, B, CD, R) -> (L, B, N)
    M.np = M.CD; M.nq = R; M.nz = D * L * B;
  }
  M.tiles_q = (M.nq + 31) / 32;
  const long long tiles = ((M.np + 31) / 32) * M.tiles_q;
  if (tiles == 0 || M.nz == 0) return (int)cudaGetLastError();
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles,
                  (unsigned)(M.nz < 65535 ? M.nz : 65535));
  const bool vec = M.CD % 4 == 0 && R % 4 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)in % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* i = (const uint32_t*)in;
  if (mode == kUnpack) {
    if (vec) move_kernel<kUnpack, true><<<grid, 256, 0, st>>>(o, i, M);
    else move_kernel<kUnpack, false><<<grid, 256, 0, st>>>(o, i, M);
  } else {
    if (vec) move_kernel<kEpilogue, true><<<grid, 256, 0, st>>>(o, i, M);
    else move_kernel<kEpilogue, false><<<grid, 256, 0, st>>>(o, i, M);
  }
  return (int)cudaGetLastError();
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
  if (mode == kPrologue)
    four_step_kernel<W, kPrologue><<<grid, block, 0, st>>>(o, i, t, S, P);
  else
    four_step_kernel<W, kTwiddle><<<grid, block, 0, st>>>(o, i, t, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 prologue, 1 twiddle and pack, 2 unpack, 3 epilogue (shapes
// above); table: the shift powers (prologue; null for shift 1) or the
// generator powers (twiddle), (2W, R C); d: the coefficient count
// (prologue); s: this shard (prologue, twiddle).  UNPACK and EPILOGUE move
// 2 x words limb planes (any width) and read neither table nor field.
extern "C" int four_step_launch(int mode, void* out, const void* in,
                                const void* table, long long B, long long D,
                                long long R, long long C, long long d,
                                long long s, int words, const uint32_t* field,
                                void* stream) {
  if (mode == kUnpack || mode == kEpilogue)
    return launch_move(mode, out, in, B, D, R, C, 2LL * words, stream);
  FP_DISPATCH_WORDS(words, launch, mode, out, in, table, B, D, R, C, d, s,
                    field, stream)
}
