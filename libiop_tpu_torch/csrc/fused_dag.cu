// K8: one launch evaluates a whole virtual-oracle DAG over a codeword domain.
//
// Replaces the JAX reference's fused DAG dispatch
// (libiop_tpu/iop/runtime.py:366 get_fused_oracle_evaluations), which traces
// the traced_contents of every virtual oracle under a set of roots
// (lincheck.py:157, r1cs_rs_iop.py:71 and :106, sumcheck.py:99,
// common.py:183, ldt_reducer.py:142) into one XLA program.  Every node of
// those DAGs is elementwise over the codeword positions: products, sums and
// differences of whole codewords (oracles and auxiliary tables such as
// vanishing evaluations, inverse points and x^delta bumps) and of broadcast
// scalars (challenges, claimed sums).
//
// The host (kernels/fused_dag.py) compiles the DAG into a straight-line tape
// with registers allocated by liveness.  Instruction word:
//   bits 0-1 op (0 add, 1 sub, 2 mul, 3 store), bits 2-7 dst (a register,
//   or an output for store), bits 8-19 operand a, bits 20-31 operand b;
//   operand = kind << 10 | index, kind 0 register, 1 input codeword,
//   2 scalar.
// Codewords are (2W, n) int32 limb arrays; scalars are W 32-bit Montgomery
// limbs in the launch parameters, at a stride of kMaxWords words so that
// the parameter block has one layout for both instantiations (W = 6,
// edwards_Fr; W = 8, alt_bn128_Fr).
//
// Design (first, simple): one thread per position interprets the tape: it
// fetches each operand (a register, 2W limbs of an input at its position,
// or a scalar), runs the field op (field.cuh) and writes a register or,
// for a store, 2W limbs of an output.  The tape and scalars travel in the
// kernel's parameter space (__grid_constant__, no copy), so a call costs
// one launch and no host-to-device copy.  The register file is indexed at
// run time and so lives in local memory (L1-cached).
//
// Over a binary field GF(2^k) the same tape runs through a second
// instantiation (fused_dag_gf2_launch, W = 2, 4, 6, 8): add and sub are
// XOR, mul is gf2k.cuh's product, codewords are (W, n) word arrays and
// scalars W raw words.
//
// Bound on the H100: memory where the DAG is input-heavy (8W bytes per input
// codeword element, ~8W^2 integer instructions per product), operations
// where products dominate.
#include <cuda_runtime.h>

#include "field.cuh"
#include "gf2k.cuh"

namespace {

constexpr int kMaxInputs = 32;
constexpr int kMaxOutputs = 4;
constexpr int kMaxScalars = 48;
constexpr int kMaxOps = 192;
constexpr int kMaxRegs = 16;

enum : uint32_t { kAdd = 0, kSub = 1, kMul = 2, kStore = 3 };
enum : uint32_t { kReg = 0, kInput = 1, kScalar = 2 };

// Layout shared with kernels/fused_dag.py (_DagParams, a ctypes.Structure).
struct DagParams {
  const uint32_t* inputs[kMaxInputs];
  uint32_t* outputs[kMaxOutputs];
  uint32_t scalars[kMaxScalars * fp::kMaxWords];
  uint32_t ops[kMaxOps];
  int n_ops;
  long long n;
};

template <int W>
struct LaunchParams {
  DagParams d;
  fp::Params<W> P;
};

template <int W>
__device__ __forceinline__ void fetch(uint32_t x[W], uint32_t operand,
                                      const DagParams& d,
                                      uint32_t reg[kMaxRegs][W], size_t i) {
  const uint32_t kind = operand >> 10, idx = operand & 1023u;
  if (kind == kInput) {
    fp::load<W>(x, d.inputs[idx], (size_t)d.n, i);
  } else if (kind == kScalar) {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = d.scalars[idx * fp::kMaxWords + j];
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = reg[idx][j];
  }
}

template <int W>
__global__ void fused_dag_kernel(const __grid_constant__ LaunchParams<W> lp) {
  const DagParams& d = lp.d;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)d.n) return;
  uint32_t reg[kMaxRegs][W];
  for (int k = 0; k < d.n_ops; ++k) {
    const uint32_t w = d.ops[k];
    const uint32_t op = w & 3u, dst = (w >> 2) & 63u;
    uint32_t x[W], y[W];
    fetch<W>(x, (w >> 8) & 0xfffu, d, reg, i);
    if (op == kStore) {
      fp::store<W>(d.outputs[dst], (size_t)d.n, i, x);
      continue;
    }
    fetch<W>(y, w >> 20, d, reg, i);
    if (op == kAdd)
      fp::add_mod<W>(x, x, y, lp.P);
    else if (op == kSub)
      fp::sub_mod<W>(x, x, y, lp.P);
    else
      fp::mont_mul<W>(x, x, y, lp.P);
#pragma unroll
    for (int j = 0; j < W; ++j) reg[dst][j] = x[j];
  }
}

template <int W>
int launch(const void* params, const uint32_t* field, void* stream) {
  LaunchParams<W> lp;
  lp.d = *(const DagParams*)params;
  lp.P = fp::params_from<W>(field);
  if (lp.d.n_ops < 0 || lp.d.n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  if (lp.d.n > 0)
    fused_dag_kernel<W><<<(unsigned)((lp.d.n + threads - 1) / threads),
                          threads, 0, (cudaStream_t)stream>>>(lp);
  return (int)cudaGetLastError();
}

template <int W>
struct LaunchParamsGF2 {
  DagParams d;
  gf::Taps T;
};

template <int W>
__device__ __forceinline__ void fetch_gf2(uint32_t x[W], uint32_t operand,
                                          const DagParams& d,
                                          uint32_t reg[kMaxRegs][W],
                                          size_t i) {
  const uint32_t kind = operand >> 10, idx = operand & 1023u;
  if (kind == kInput) {
    gf::load<W>(x, d.inputs[idx], (size_t)d.n, i);
  } else if (kind == kScalar) {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = d.scalars[idx * fp::kMaxWords + j];
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = reg[idx][j];
  }
}

template <int W>
__global__ void fused_dag_gf2_kernel(
    const __grid_constant__ LaunchParamsGF2<W> lp) {
  const DagParams& d = lp.d;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)d.n) return;
  uint32_t reg[kMaxRegs][W];
  for (int k = 0; k < d.n_ops; ++k) {
    const uint32_t w = d.ops[k];
    const uint32_t op = w & 3u, dst = (w >> 2) & 63u;
    uint32_t x[W], y[W];
    fetch_gf2<W>(x, (w >> 8) & 0xfffu, d, reg, i);
    if (op == kStore) {
      gf::store<W>(d.outputs[dst], (size_t)d.n, i, x);
      continue;
    }
    fetch_gf2<W>(y, w >> 20, d, reg, i);
    if (op == kMul)
      gf::mul<W>(x, x, y, lp.T);
    else
      gf::add<W>(x, x, y);
#pragma unroll
    for (int j = 0; j < W; ++j) reg[dst][j] = x[j];
  }
}

template <int W>
int launch_gf2(const void* params, const uint32_t* taps, void* stream) {
  LaunchParamsGF2<W> lp;
  lp.d = *(const DagParams*)params;
  lp.T = gf::taps_from(taps);
  if (lp.d.n_ops < 0 || lp.d.n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  if (lp.d.n > 0)
    fused_dag_gf2_kernel<W><<<(unsigned)((lp.d.n + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(lp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_dag_gf2_launch(const void* params, int words,
                                    const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch_gf2, params, taps, stream)
}

extern "C" int fused_dag_launch(const void* params, int words,
                                const uint32_t* field, void* stream) {
  FP_DISPATCH_WORDS(words, launch, params, field, stream)
}
