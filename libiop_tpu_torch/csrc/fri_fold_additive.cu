// K19: one additive FRI fold of a natural-order codeword over an affine
// subspace of GF(2^k).
//
// Replaces the JAX reference's fold_codeword_additive
// (libiop_tpu/protocols/fri.py:240).  The cosets of the localizer subspace
// V (the first eta basis vectors) are contiguous: coset j holds positions
// j*c .. j*c + c - 1, c = 2^eta.  At the challenge x the folded value is the
// coset's Lagrange interpolation, eps^-1 (Z_V(x) + Z_V(shift_j)) *
// sum_e f(e) / (x - e) (eps the linear coefficient of Z_V, Z_V(shift_j) the
// coset's constant offset), or f(e) exactly where x is the coset element e.
//
// Design (first, simple): one thread per coset.  It reads the c values and
// the c elements (the domain's memoized subset-sum table), forms x - e =
// x ^ e, inverts each nonzero difference with the Itoh-Tsujii chain in
// registers (gf2k.cuh), XOR-accumulates f(e) (x - e)^-1, scales by
// eps^-1 (Z_V(x) ^ offset_j) (the offsets table memoized per domain) and
// selects f(e) where x is a member.  x, Z_V(x) and eps^-1 are launch
// parameters.
//
// Bound on the H100: integer instructions.  Each element costs one
// inversion (k - 1 squarings and ~log2(k) + popcount(k - 1) products) and
// one product, each coset one more; batch inversion (three products an
// element and one inversion a block) is later work.
#include <cuda_runtime.h>

#include "gf2k.cuh"

namespace {

template <int W>
struct FoldParams {
  uint32_t x[W];
  uint32_t zv_x[W];
  uint32_t eps_inv[W];
  gf::Taps T;
};

template <int W>
__global__ void fri_fold_additive_kernel(uint32_t* __restrict__ out,
                                         const uint32_t* __restrict__ v,
                                         const uint32_t* __restrict__ elems,
                                         const uint32_t* __restrict__ offs,
                                         size_t N, int c,
                                         const __grid_constant__ FoldParams<W> P) {
  const size_t nc = N / c;
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nc) return;
  uint32_t acc[W], sel[W], f[W], e[W], t[W];
  gf::set_zero<W>(acc);
  gf::set_zero<W>(sel);
  bool member = false;
  for (int k = 0; k < c; ++k) {
    const size_t pos = j * c + k;
    gf::load<W>(f, v, N, pos);
    gf::load<W>(e, elems, N, pos);
    gf::add<W>(e, e, P.x);
    if (gf::is_zero<W>(e)) {
      member = true;
      gf::add<W>(sel, sel, f);
      continue;
    }
    gf::inv<W>(t, e, P.T);
    gf::mul<W>(t, t, f, P.T);
    gf::add<W>(acc, acc, t);
  }
  if (!member) {
    gf::load<W>(t, offs, nc, j);
    gf::add<W>(t, t, P.zv_x);
    gf::mul<W>(t, t, P.eps_inv, P.T);
    gf::mul<W>(sel, acc, t, P.T);
  }
  gf::store<W>(out, nc, j, sel);
}

template <int W>
int launch(void* out, const void* v, const void* elems, const void* offs,
           long long N, int c, const uint32_t* scalars, const uint32_t* taps,
           void* stream) {
  if (c < 1 || N % c) return (int)cudaErrorInvalidValue;
  FoldParams<W> P;
  for (int w = 0; w < W; ++w) {
    P.x[w] = scalars[w];
    P.zv_x[w] = scalars[W + w];
    P.eps_inv[w] = scalars[2 * W + w];
  }
  P.T = gf::taps_from(taps);
  const long long nc = N / c;
  const int threads = 128;
  if (nc > 0)
    fri_fold_additive_kernel<W>
        <<<(unsigned)((nc + threads - 1) / threads), threads, 0,
           (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)v,
                                   (const uint32_t*)elems,
                                   (const uint32_t*)offs, (size_t)N, c, P);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (W, N/c); v, elems: (W, N); offs: (W, N/c); scalars: x, Z_V(x),
// eps^-1 (W words each)
extern "C" int fri_fold_additive_launch(void* out, const void* v,
                                        const void* elems, const void* offs,
                                        long long N, int c, int words,
                                        const uint32_t* scalars,
                                        const uint32_t* taps, void* stream) {
  GF_DISPATCH_WORDS(words, launch, out, v, elems, offs, N, c, scalars, taps,
                    stream)
}
