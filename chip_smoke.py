"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--log_n 16]

Phases (any failure exits non-zero and prints no result line):
 1. require a CUDA device; print the card's name and power limit;
 2. build the hand-written kernels from libiop_tpu_torch/csrc (one nvcc per
    source, in parallel) and the native pow solver; print the build seconds;
 3. hold each field kernel K1-K7 and K13-K15 (and K3 on salted zk leaves)
    against its plain PyTorch twin on the card at the main paths' shapes
    (exact equality), over edwards_Fr (6-word instantiations) and
    alt_bn128_Fr (8-word), and time both with CUDA events (K2: the passes
    of ntt_plan over one transform of 2^(log_n + 3), forward and inverse
    tables, timed device-only in place); K13 also at
    column counts that are not multiples of 4, a sentinel-only map, int32
    and int64 maps, aligned and at an offset;
 4. golden: the Aurora proofs of the reference's golden configuration,
    non-zk and zk (Merkle salts from a seeded stream), of its Poseidon
    configuration over alt_bn128_Fr (poseidon, poseidon_high_alpha, and
    poseidon with zk) and its Ligero proofs (non-zk and zk), proven on the
    card, hash to the JAX package's sha256s; they verify, and a flipped
    byte or a wrong primary input is rejected;
 5. main path: Aurora prove + verify at 2^log_n constraints with bench.py's
    configuration over edwards_Fr with BLAKE2b, non-zk; every kernel of the
    path must be launched (count > 0) and no plain twin may run on a CUDA
    tensor;
 6. zk main path: the same configuration with make_zk=True, the same checks;
    then K8 against its twin on the DAG of its fri_combine_inputs call;
 7. the same two paths over alt_bn128_Fr with Poseidon trees and the
    Poseidon hashchain (hash_name="poseidon"), the same checks, K8 on the
    zk DAG;
 8. Ligero prove + verify at 2^log_n constraints with bench.py's
    configuration over edwards_Fr with BLAKE2b, non-zk then zk, the same
    checks; then K2 and K9-K15 against their twins on the largest input
    each got on the paths of each field (recorded during the paths; K2's
    is the zk codeword's transform), and K3 and K11 at the shape those
    paths called them with most often (``calls_by_shape``);
 9. Aurora over GF(2^192) (bench.py's aurora_gf192 stage: 15 inputs,
    security 128, RS extra 2, FRI localization 1, pow 20 bits, example
    default_rng(0)) at 2^log_n constraints, non-zk, the same checks; the
    phase-3 checks also hold K16-K19 and K8's GF(2^k) instantiation
    against their twins (K16 over gf64 and gf192 on 2^20 elements, K17
    forward and inverse at 2^20, K19 at eta = 1 on 2^20) and phase 4 the
    additive golden digests (GF(2^64), non-zk and zk);
10. the same GF(2^192) path with make_zk=True (prover rng default_rng(0)),
    then K8 on its zk DAG and K18 on the largest and the deepest division
    and the largest product the binary paths gave it (the row sums the
    three; ``deep_division`` times the deep one on its own, with its
    launches, segment, segments and dependent steps);
11. Fractal over edwards_Fr at 2^log_n constraints with bench.py's
    configuration (bench.py:246-300: security 128, RS extra 2, FRI
    localization 2, BLAKE2b, example default_rng(0) with 15 inputs,
    prover rng default_rng(1)): indexer (timed apart), prove and verify,
    non-zk then zk (salts from default_rng(7)), the same checks (a flipped
    byte of the first round-1 root; the index roots are the verifier's);
    K8 on the zk DAG; phase 4 also proves the JAX package's Fractal
    configuration (tests/test_fractal.py:63-98) and its Ligero over
    GF(2^64) and alt_bn128_Fr (tests/test_additive_aurora.py:114-137) to
    their pinned digests;
12. Ligero over GF(2^64) at 2^(log_n - 1) constraints (bench.py's Ligero
    configuration), the same checks; then K20 and K21 against their twins
    on the largest calls the Fractal paths made (K20 also on that input
    with zeros written in), and K15's GF(2^k) instantiation and K17's
    batched transform on the largest calls the GF(2^64) Ligero path made;
13. Fractal over GF(2^192) at 2^log_n constraints (bench.py's Fractal
    configuration with FRI localization 1, as its aurora_gf192 stage):
    indexer (timed apart), prove and verify, non-zk then zk, the same
    checks; K8 on the zk DAG; then the GF(2^k) instantiations of K7, K10,
    K11 and K21 against their twins on the largest call each got on the
    GF(2^192) paths (phases 9, 10, 13) and on the GF(2^64) ones (phase 4's
    gf64 Fractal and Ligero pins, phase 12); the binary paths of phases
    9-13 must launch them; K17 at the call shape the GF(2^192) paths made
    most often (``calls_by_shape`` counts them all), K19 on their largest
    fold, and K16 and K11 at their most frequent shapes on those paths;
    phase 4 also proves the JAX package's Fractal over GF(2^64)
    (tests/test_additive_aurora.py:139-157) to its pins;
14. the FRI SNARK (fri_snark_prover / fri_snark_verifier) over edwards_Fr
    with BLAKE2b: security 128, RS extra 2, localization parameter 2, 10
    queries, 1 interactive repetition, four oracles, pow 0, tested degree
    2^(log_n + 2) (codeword 2^(log_n + 4), 2^20 by default), prover rng
    default_rng(0): cold and warm prove, verify, argument bytes, peak
    memory, the device's busy share; a flipped root byte is rejected;
15. the instrument CLI (libiop_tpu_torch.profiling.instrument) in process
    on the card for aurora, fractal, ligero and fri at 2^8; every line
    accepted, the fri run prints its transcript report;
16. K22 through BivariateLagrange.evaluations_over with |S| = 2^16 and
    |L| = 2^20 disjoint, x off L and on L, over edwards_Fr, alt_bn128_Fr,
    GF(2^192) and GF(2^64): one launch a call, equal to its twin, timed;
17. the four-step NTT: ShardedNTT at codeword 2^20 over edwards_Fr and
    alt_bn128_Fr on in-process meshes of D = 1, 2, 4 and 8 shards on the
    card, shift 1 and a coset shift, equal to fft (K2) byte for byte; K23's
    four launch shapes against their twins; ShardedNTT's ms beside fft's;
    K23's unpack and epilogue at C/D = 1, 2 and 4, R = D and batch 3;
18. the sharded Aurora prover: phase 5's configuration under
    codeword_sharding_context of a 4-shard mesh on the card gives phase
    5's bytes, takes the four-step route and launches every K23 shape; the
    golden configuration under the mesh gives GOLDEN_SHA256; K23 against
    its twins on the prove's largest calls;
19. the same proof across two processes on the card (this script with
    --mesh_rank, backend gloo, a file:// rendezvous, both ranks on cuda:0,
    killed after a timeout): assert_same_on_all_processes holds and the
    digest is phase 5's; with two GPUs also backend nccl;
20. K24 (the LDT combination): launched on ligero, ligero_zk and
    ligero_gf64, equal to its twin on their largest calls (and over
    alt_bn128_Fr at the edwards shape); the Ligero pins of phase 4 proven
    again with K24;
21. K25 (the Lagrange basis of a domain at a point): through
    lagrange_coefficients_any at |H| = 2^20 over edwards_Fr, alt_bn128_Fr,
    GF(2^192) and GF(2^64), alpha off H and on H (the one-hot vector), and
    through poly.lagrange_coefficients at a device alpha over edwards_Fr:
    one launch a call, equal to its twin, timed; then the microbench's
    lagrange suite in process on the card at 2^10-2^18, every line parsed
    and K25 launched;
22. print the card's name and power limit, the kernels JSON line, then the
    device JSON line last.  A kernel row's ``ms`` is its device-only time a
    call (device_ms: n back-to-back calls between two CUDA events, queued
    behind a spin kernel so that no host dispatch falls inside; ``ms_by``
    says how it was taken), ``call_ms`` one call between two events, host
    dispatch included; ``library_ms`` and ``library_call_ms`` time the
    PyTorch call of the same function (K13, K23's unpack and epilogue) the
    same two ways; ``plain_ms`` is single-call; K17's rows carry
    ``launches_per_transform``, the launches one call of the row's
    transform adds to its count (checked equal to its plan's passes).
Imports nothing of JAX or of the JAX package.
"""
import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import secrets
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from libiop_tpu_torch import kernels  # noqa: E402
from libiop_tpu_torch.bcs import common as bcs_common  # noqa: E402
from libiop_tpu_torch.bcs.common import BCSTranscript  # noqa: E402
from libiop_tpu_torch.fields import limbs  # noqa: E402
from libiop_tpu_torch.fields.limbs import (lazy_sum_reduce_plain,  # noqa: E402
                                           mont_reduce_wide_plain, mul_plain)
from libiop_tpu_torch.algebra import domains, generic, poly  # noqa: E402
from libiop_tpu_torch.algebra import fft as alg_fft  # noqa: E402
from libiop_tpu_torch.algebra import linearized as alg_linearized  # noqa: E402
from libiop_tpu_torch.algebra import subspace  # noqa: E402
from libiop_tpu_torch.fields import prime as prime_mod  # noqa: E402
from libiop_tpu_torch.fields import binary as binary_mod  # noqa: E402
from libiop_tpu_torch.fields.binary import gf64, gf192  # noqa: E402
from libiop_tpu_torch.kernels.additive_fft import (  # noqa: E402
    additive_fft, additive_fft_plain, additive_fft_plan)
from libiop_tpu_torch.kernels.fri_fold_additive import (  # noqa: E402
    fri_fold_additive, fri_fold_additive_plain)
from libiop_tpu_torch.kernels.gf2k_mul import (  # noqa: E402
    gf2k_inv, gf2k_inv_plain, gf2k_mul, gf2k_mul_plain, gf2k_square,
    gf2k_square_plain)
from libiop_tpu_torch.kernels.linearized import (  # noqa: E402
    linearized_divide, linearized_divide_plain, linearized_multiply,
    linearized_multiply_plain, scan_segment)
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr  # noqa: E402
from libiop_tpu_torch.iop import runtime  # noqa: E402
from libiop_tpu_torch.kernels import build  # noqa: E402
from libiop_tpu_torch.kernels import blake2b as k3  # noqa: E402
from libiop_tpu_torch.kernels import poseidon as k9  # noqa: E402
from libiop_tpu_torch.kernels.batch_inv import (batch_inv,  # noqa: E402
                                                batch_inv_plain)
from libiop_tpu_torch.kernels.blake2b import (blake2b_rows,  # noqa: E402
                                              blake2b_rows_plain, merkle_heap)
from libiop_tpu_torch.kernels.bivariate import (  # noqa: E402
    bivariate_evals, bivariate_evals_plain)
from libiop_tpu_torch.kernels.ell_matvec import (  # noqa: E402
    ell_matvec, ell_matvec_gf2_plain, ell_matvec_plain)
from libiop_tpu_torch.kernels.field_addsub import (field_addsub,  # noqa: E402
                                                   field_addsub_plain)
from libiop_tpu_torch.kernels.fri_fold import fri_fold, fri_fold_plain  # noqa: E402
from libiop_tpu_torch.kernels.fused_dag import (ADD, MUL, SUB,  # noqa: E402
                                                fused_dag, fused_dag_plain)
from libiop_tpu_torch.kernels.horner import (  # noqa: E402
    blocking, horner, horner_gf2_plain, horner_plain)
from libiop_tpu_torch.kernels.lagrange import (  # noqa: E402
    lagrange_coeffs, lagrange_coeffs_plain)
from libiop_tpu_torch.kernels.lazy_reduce import lazy_reduce  # noqa: E402
from libiop_tpu_torch.kernels.mont_mul import mont_mul  # noqa: E402
from libiop_tpu_torch.kernels import place_columns as k13  # noqa: E402
from libiop_tpu_torch.kernels.ntt import (ntt_plan, ntt_stages,  # noqa: E402
                                          ntt_stages_plain)
from libiop_tpu_torch.kernels.p_alpha_m import (  # noqa: E402
    p_alpha_m, p_alpha_m_gf2_plain, p_alpha_m_plain)
from libiop_tpu_torch.kernels.powers import (  # noqa: E402
    powers, powers_gf2_plain, powers_plain)
from libiop_tpu_torch.kernels.row_dot import row_dot, row_dot_plain  # noqa: E402
from libiop_tpu_torch.kernels.rs_encode import (rs_encode,  # noqa: E402
                                                rs_encode_plain)
from libiop_tpu_torch.kernels.vanishing import (  # noqa: E402
    vanishing_divide, vanishing_divide_plain, vanishing_multiply,
    vanishing_multiply_plain)
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset  # noqa: E402
from libiop_tpu_torch.algebra.fft import SHARD_ROUTES, fft  # noqa: E402
from libiop_tpu_torch.kernels import four_step as k23  # noqa: E402
from libiop_tpu_torch.kernels.ldt_combine import (  # noqa: E402
    ldt_combine, ldt_combine_plain)
from libiop_tpu_torch.parallel.mesh import (  # noqa: E402
    codeword_sharding_context, make_codeword_mesh)
from libiop_tpu_torch.parallel.shard_ntt import ShardedNTT  # noqa: E402
from libiop_tpu_torch.protocols import ldt_reducer  # noqa: E402
from libiop_tpu_torch.protocols import common, fri, ligero  # noqa: E402
from libiop_tpu_torch.protocols import holographic_lincheck  # noqa: E402
from libiop_tpu_torch.relations import sparse  # noqa: E402
from libiop_tpu_torch.relations.examples import generate_r1cs_example  # noqa: E402
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,  # noqa: E402
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from libiop_tpu_torch.snark.fractal import (  # noqa: E402
    FractalSnarkParams, fractal_snark_indexer, fractal_snark_prover,
    fractal_snark_verifier)
from libiop_tpu_torch.snark.ligero import (LigeroSnarkParams,  # noqa: E402
                                           ligero_snark_prover,
                                           ligero_snark_verifier)
from libiop_tpu_torch.snark.fri import (FRISnarkParams,  # noqa: E402
                                        fri_snark_prover, fri_snark_verifier)
from libiop_tpu_torch.algebra.bivariate import (  # noqa: E402
    BivariateLagrange, index_of_element)
from libiop_tpu_torch.profiling import instrument, microbench  # noqa: E402
from libiop_tpu_torch.utils.profiling import PROFILER  # noqa: E402
from tools.device_timing import (DEVICE_MAX_CALLS, cupti_ms,  # noqa: E402
                                 time_ms, timing)

#: sha256 of the golden transcript, pinned by the JAX package's own test
#: (tests/test_golden_transcript.py:22)
GOLDEN_SHA256 = "ca51f9c12bb0f3383b696ad92bd3b7af9a13acd29463a760d5dd61d7d7db17ce"
#: sha256 of the golden configuration with make_zk=True, prover rng
#: default_rng(0) and secrets.token_bytes drawn from default_rng(7), as the
#: JAX package's prover gives it (tests/test_torch_zk_aurora.py)
GOLDEN_ZK_SHA256 = \
    "02e9bb70ba8ffbde03f75e379618274cdd4565c4256bb52ea9d1bd3b70e70f55"
#: sha256s of the JAX package's Aurora proofs over alt_bn128_Fr in its
#: Poseidon configuration (tests/test_poseidon.py:91-112, example from
#: default_rng(77), prover rng default_rng(78), salts from default_rng(7)):
#: case -> (hash_name, make_zk, sha256)  (tests/test_torch_poseidon_aurora.py)
POSEIDON_PINS = {
    "poseidon": ("poseidon", False,
                 "302af824056aa90b2df01250d8a5d60e3d3aafa42f28ca8ea28e8424c6608337"),
    "poseidon_high_alpha": (
        "poseidon_high_alpha", False,
        "3d00d3f11c6139d39ce3f03054b9114c01d439b1c7ed6197c96e87a4e9803fb2"),
    "poseidon_zk": ("poseidon", True,
                    "50ebc919c82250acc2c1d3183d0bcdc48d4eae4b02410956d9e42011816c12ae"),
}

#: sha256s of the JAX package's Ligero proofs in its SNARK test
#: configuration (tests/test_snark_wrappers.py:16: 16 constraints, example
#: from default_rng(12345), security 32, RS extra 2, pow 2, one
#: interaction, 4 queries, one LDT instance, prover rng default_rng(7),
#: salts from default_rng(7)): make_zk -> sha256
#: (tests/test_torch_ligero.py)
LIGERO_PINS = {
    False: "c4bf652076e40e8813bb563eb3d678b2becee3ff4c927807666a11d39b95a3fc",
    True: "4dcd9d150b81cfdd4494d54776ba96a774b7154b0fa9209cbc4a3ab9997c5aa8"}

#: sha256s of the JAX package's additive golden configuration
#: (tests/test_additive_aurora.py:82-88: GF(2^64), 16 constraints, example
#: from default_rng(777), prover rng default_rng(0)): non-zk its own pin
#: ADDITIVE_GOLDEN_SHA256, zk with the salts from default_rng(7)
#: (tests/test_torch_additive_aurora.py): make_zk -> sha256
ADDITIVE_PINS = {
    False: "8a7c80d5983fb537d0c3ea970110ffe7cbdbaf7020e54ea5f4ad3701273981e9",
    True: "ca0f0a1485857e5bc738f1778561db2a2c453c4c94588c26ed6c8cca5b0958dd"}

#: the JAX package's Fractal SNARK in its test configuration
#: (tests/test_fractal.py:63-98: 16 constraints, example from
#: default_rng(12345), security 32, RS extra 1, FRI localization 1, pow 2,
#: 4 queries, one repetition, one LDT instance, one lincheck repetition,
#: indexer rng default_rng(2), prover rng default_rng(3), salts from
#: default_rng(7)): make_zk -> (sha256 of the index roots in key order,
#: sha256 of the proof)  (tests/test_torch_fractal.py)
FRACTAL_PINS = {
    False: ("5c1c47f95a92264ead18fbbad32f58b19c50fb18c470c0bb879581f224ec332a",
            "c331495442d9c6c6e2bdbb6e43238d2842fe142ac184bef9dfb20858d7eb0ba0"),
    True: ("cb5405b37a03ca61b33e69a8c4bf17e516a5453cce44a8a22c983ff76f4eaf4d",
           "397b367b9f301b48f136b0e58f9953d204706230e5eca8a8f2836622ca1595d7")}

#: the JAX package's Fractal SNARK over GF(2^64) in
#: tests/test_additive_aurora.py:139-157 (16 constraints, example from
#: default_rng(51), security 32, RS extra 2, FRI localization 1, 3 queries,
#: one repetition, one LDT instance, prover rng default_rng(52), salts from
#: default_rng(7)): make_zk -> (sha256 of the index roots in key order,
#: sha256 of the proof)  (tests/test_torch_fractal_additive.py)
FRACTAL_ADDITIVE_PINS = {
    False: ("d120168b33d1fa2f502aa62ea4c4f091785e4f62b4149acc4239de94dba6adcd",
            "6feb5d34322564ed68a04d3d06ea1a91d8c9faa0136d48ee7c891363e7c798c6"),
    True: ("0d55b85be312e7cf0ad387c653aaea14b5417778e89265579fb17e6b46fa3342",
           "ebc3f504721aef88054290185c73447274510f02318069883fcb6bafe8b057f5")}

#: the JAX package's Ligero SNARK in tests/test_additive_aurora.py:114-137
#: (16 constraints, example from default_rng(41), security 32, RS extra 2,
#: height/width 1.0, prover rng default_rng(42)) over GF(2^64) and over
#: alt_bn128_Fr: case -> (field, hash_name, sha256)
#: (tests/test_torch_ligero_additive.py)
LIGERO_41_PINS = {
    "gf64": ("gf64", "blake2b",
             "f430a1dfffed9ba5d208c40fe3eb431572a43c92363955e22e706ee0cc6ae5ce"),
    "bn128_blake2b": (
        "alt_bn128", "blake2b",
        "487792ef0780af2380ce49ef93c92584fe8a7929f60246bf0a384857e22a029a"),
    "bn128_poseidon": (
        "alt_bn128", "poseidon",
        "a8b0f4f1b58a739b3af2202ced8907fa25919f3bd1b219b15609010a31d6da86")}

# Least-time model of the H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM3;
# 32-bit integer instructions at 64 lanes per SM x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def elem_bytes(F):
    """One field element in device memory: L int32 limbs (48 or 64 B)."""
    return 4 * F.L


# 32-bit integer instructions per operation (lower bounds), for W = L/2
# 32-bit words:
def mont_ops(F):
    """A CIOS product: 300 at W = 6 (150 multiplies, lo/hi, and 150 carry
    adds), growing as W^2 (533 at W = 8)."""
    return round(300 * (F.L // 2) ** 2 / 36)


def half_mont_ops(F):
    """A W x W wide product (no reduction), or the Montgomery reduction of
    one: each about half a CIOS product (W^2 multiplies, lo/hi, and their
    carry adds)."""
    return round(mont_ops(F) / 2)


def addsub_ops(F):
    """A W-word add/sub with carry and conditional select: 4 per word."""
    return 4 * (F.L // 2)


# 32-bit integer instructions of GF(2^k) operations (k = 32 W), for the
# cheapest route known here, not the kernels' Horner product:
def gf_mul_ops(W):
    """A product as a 4-bit window comb on V = W/2 64-bit words (each
    64-bit op two 32-bit ones): the 16-entry table of b's nibble multiples
    (3 shifts of V+1 words at 3 ops a word, 11 XORs of V+1 words), 16
    nibble positions x V words of a (extract 2, load and XOR V+1 words
    each), 15 shifts of the 2V-word accumulator (3 a word); then the fold
    through 4 taps (4 ops a 32-bit word).  484 at W = 2, 1,756 at W = 6."""
    V = W // 2
    return 2 * (20 * (V + 1) + 16 * V * (2 + 2 * (V + 1)) + 45 * 2 * V) \
        + 16 * W


def gf_square_ops(W):
    """A square: spread each 16-bit half (8 ops), then the fold."""
    return 16 * W + 16 * W


def gf_batch_inv_ops(W):
    """An element's share of a batch inversion (Montgomery's trick: three
    products an element, one inversion a batch), the least work an
    inversion of many elements needs; the kernels invert each element by
    the Itoh-Tsujii chain (k squarings and ~log2(k) + popcount(k-1)
    products) instead."""
    return 3 * gf_mul_ops(W)


# 12 rounds x 8 G x (6 add64 + 4 xor64 + 3 rot64) at 2 instructions each; the
# fourth rotate of G is by 32, a swap of the two halves, and costs nothing
BLAKE2B_BLOCK_OPS = 12 * 8 * (6 + 4 + 3) * 2


_T0 = time.time()


def log(msg):
    if msg.startswith("phase "):
        msg += f" (at {time.time() - _T0:.1f} s)"
    print(msg, flush=True)


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_products(n, first_m=1):
    """Montgomery products of the radix-2 NTT stages m = first_m, ..., n/2
    of size n: each butterfly whose twiddle is not 1 (stage m uses m
    twiddles, n/(2m) butterflies each)."""
    return sum((m - 1) * (n // (2 * m))
               for m in (1 << s for s in range(n.bit_length() - 1))
               if m >= first_m)


def ntt_work(F, rows, n, first_m=1):
    """(bytes, instructions) of the stages m = first_m, ..., n/2 over rows
    of n: the array read and written once and the n/2 twiddles read; a
    product a butterfly whose twiddle is not 1, an add and a sub each."""
    stages = (n // first_m).bit_length() - 1
    return (elem_bytes(F) * (2 * rows * n + n // 2),
            rows * (ntt_products(n, first_m) * mont_ops(F)
                    + stages * n * addsub_ops(F)))


def add_times(rows_times):
    """The times of a row that sums several calls."""
    hows = sorted({t["ms_by"].split(",")[0] for t in rows_times})
    return {"ms": sum(t["ms"] for t in rows_times),
            "call_ms": sum(t["call_ms"] for t in rows_times),
            "ms_by": " + ".join(hows)}


def timed_once(fn):
    """(fn(), its milliseconds) for one run on the current stream (CUDA
    events): for a plain twin too slow to run more than once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_elems(F, n, rng, dev):
    return F.from_ints(F.random_ints(n, rng), dev)


def check_kernels(F, dev, rng, cs_main, blake2b=True):
    """Phase 3: K1-K7 and K13-K15 against their twins at the main paths'
    shapes for cs_main, the main path's constraint system of 2^k
    constraints (k capped at 16) over F: non-zk Aurora codewords of
    2^(k+2), zk codewords of 2^(k+4), and the row encodes and row sums of
    Ligero at 2^k.  K3 (BLAKE2b, no field) only with ``blake2b``."""
    rows = []
    k = min(cs_main.num_constraints.bit_length() - 1, 16)
    L = F.L
    ELEM_BYTES, MONT_OPS, ADDSUB_OPS = elem_bytes(F), mont_ops(F), addsub_ops(F)

    # K1: Montgomery product on (L, 2^(k+3))
    n = 1 << (k + 3)
    a, b = random_elems(F, n, rng, dev), random_elems(F, n, rng, dev)
    got, want = mont_mul(F, a, b), mul_plain(F, a, b)
    err = max_abs_err(got, want)
    bms, by = bound_ms(3 * ELEM_BYTES * n, MONT_OPS * n)
    rows.append(dict(
        name="mont_mul", route="cuda",
        source="libiop_tpu_torch/csrc/mont_mul.cu",
        replaces="libiop_tpu/fields/prime.py:317", max_abs_err=err,
        **timing(lambda: mont_mul(F, a, b)),
        plain_ms=time_ms(lambda: mul_plain(F, a, b)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"({L}, 2^{k + 3}) x ({L}, 2^{k + 3})"))

    # K2: the k+3 butterfly stages of one NTT of size 2^(k+3), in the
    # passes of ntt_plan; timed in place (a pass takes the same device time
    # whatever field elements it holds)
    dim = k + 3
    N = 1 << dim
    dom = MultiplicativeCoset(F, dim, shift=F.multiplicative_generator)
    W = dom.generator_powers(dev)
    x0 = random_elems(F, N, rng, dev).reshape(F.L, 1, N)
    buf = x0.clone()
    err = max_abs_err(ntt_stages(F, buf, W, 1), ntt_stages_plain(F, x0, W, 1))
    winv = dom.inverse_generator_powers(dev)
    buf.copy_(x0)
    err = max(err, max_abs_err(ntt_stages(F, buf, winv, 1),
                               ntt_stages_plain(F, x0, winv, 1)))
    bms, by = bound_ms(*ntt_work(F, 1, N))
    rows.append(dict(
        name="ntt_stage", route="cuda", source="libiop_tpu_torch/csrc/ntt.cu",
        replaces="libiop_tpu/algebra/fft.py:103", max_abs_err=err,
        **timing(lambda: ntt_stages(F, buf, W, 1)),
        plain_ms=time_ms(lambda: ntt_stages_plain(F, x0, W, 1)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"{dim} stages over N = 2^{dim} (one NTT, forward and "
              f"inverse tables) in {len(ntt_plan(N, 1))} passes"))

    if blake2b:
        # K3: round-1 leaves of the non-zk path (2^(k+1) leaves of 4 oracles x
        # coset 2 x 6 words = 192 bytes, 32-byte digests) plus the full tree
        nl, nw, db = 1 << (k + 1), 48, 32
        words = torch.from_numpy(rng.integers(0, 1 << 32, size=(nl, nw),
                                              dtype=np.uint64).astype(np.uint32)
                                 .view(np.int32)).to(dev)

        def commit_kernel():
            return merkle_heap(blake2b_rows(words, 4 * nw, db, 0x00), db)

        def commit_plain():
            level = blake2b_rows_plain(words, 4 * nw, db, 0x00)
            heap = [level]
            while level.shape[0] > 1:
                level = blake2b_rows_plain(level.reshape(-1, 2 * db // 4), 2 * db,
                                           db, 0x01)
                heap.append(level)
            return torch.cat([torch.zeros_like(level)] + heap[::-1])

        err = max_abs_err(commit_kernel(), commit_plain())
        leaf_blocks = -(-(4 * nw + 1) // 128)
        bms, by = bound_ms(nl * 4 * nw + 2 * nl * db,
                           (nl * leaf_blocks + nl - 1) * BLAKE2B_BLOCK_OPS)
        rows.append(dict(
            name="blake2b_rows", route="cuda",
            source="libiop_tpu_torch/csrc/blake2b.cu",
            replaces="libiop_tpu/bcs/device_blake2b.py:198", max_abs_err=err,
            **timing(commit_kernel), plain_ms=time_ms(commit_plain),
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"2^{k + 1} leaves x 192 B + {k + 1} tree levels"))

    # K4: fold with eta = 2 on N = 2^(k+3)
    eta, c = 2, 4
    evals = random_elems(F, N, rng, dev)
    rows_t = torch.from_numpy(fri._fold_rows(F, eta)).to(dev)
    winv = dom.inverse_generator_powers(dev)
    xpow = powers_plain(F, random_elems(F, 1, rng, dev).reshape(F.L), c)
    err = max_abs_err(fri_fold(F, evals, rows_t, winv, xpow, c),
                      fri_fold_plain(F, evals, rows_t, winv, xpow, c))
    # the fold's own work per output j: a radix-2 inverse NTT of size c, the
    # 1/c scaling, y_j = G^-j * x/shift, and Horner over the c coefficients
    # in y_j; it reads the N values, the nc twiddles G^-j and x/shift
    nc = N // c
    bms, by = bound_ms(ELEM_BYTES * (N + 2 * nc + 1),
                       nc * ((ntt_products(c) + 2 + (c - 1)) * MONT_OPS
                             + (eta * c + (c - 1)) * ADDSUB_OPS))
    rows.append(dict(
        name="fri_fold", route="cuda", source="libiop_tpu_torch/csrc/fri_fold.cu",
        replaces="libiop_tpu/protocols/fri.py:133", max_abs_err=err,
        **timing(lambda: fri_fold(F, evals, rows_t, winv, xpow, c)),
        plain_ms=time_ms(lambda: fri_fold_plain(F, evals, rows_t, winv, xpow,
                                                c)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"eta = 2, N = 2^{dim} -> 2^{dim - 2}"))
    # K5: add with both operands full, sub against a broadcast scalar and
    # neg, on (L, 2^(k+4)) (a zk codeword)
    n = 1 << (k + 4)
    a, b = random_elems(F, n, rng, dev), random_elems(F, n, rng, dev)
    s = random_elems(F, 1, rng, dev)
    a[:, 0] = 0
    errs = []
    for op, x, y in (("add", a, b), ("sub", a, s), ("neg", a, None)):
        errs.append(max_abs_err(field_addsub(F, op, x, y),
                                field_addsub_plain(F, op, x, y)))
        log(f"  field_addsub {op} ({L}, 2^{k + 4}) x "
            f"{'-' if y is None else tuple(y.shape)} err {errs[-1]}")
    bms, by = bound_ms(3 * ELEM_BYTES * n, ADDSUB_OPS * n)
    rows.append(dict(
        name="field_addsub", route="cuda",
        source="libiop_tpu_torch/csrc/field_addsub.cu",
        replaces="libiop_tpu/fields/prime.py:236", max_abs_err=max(errs),
        **timing(lambda: field_addsub(F, "add", a, b)),
        plain_ms=time_ms(lambda: field_addsub_plain(F, "add", a, b)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"add ({L}, 2^{k + 4}) + ({L}, 2^{k + 4})"))

    # K6: mont_reduce_wide of a (2L+2, n) product accumulator, and
    # lazy_sum_reduce of a (L, n) lazy sum of 4096 values per column
    wide = torch.zeros((2 * F.L + 2, n), dtype=torch.int64, device=dev)
    for i in range(F.L):
        wide[i:i + F.L] += a[i].to(torch.int64) * b.to(torch.int64)
    wide_err = max_abs_err(lazy_reduce(F, wide, False),
                           mont_reduce_wide_plain(F, wide))
    log(f"  lazy_reduce mont_reduce_wide ({2 * L + 2}, 2^{k + 4}) err "
        f"{wide_err}")
    lazy = torch.randint(0, 4096 * 65535, (F.L, n), dtype=torch.int64,
                         device=dev)
    err = max(wide_err, max_abs_err(lazy_reduce(F, lazy, True),
                                    lazy_sum_reduce_plain(F, lazy)))
    # carry pass (3 ops a row) and one product-sized reduction per column
    bms, by = bound_ms(8 * F.L * n + ELEM_BYTES * n,
                       (3 * F.L + MONT_OPS) * n)
    rows.append(dict(
        name="lazy_reduce", route="cuda",
        source="libiop_tpu_torch/csrc/lazy_reduce.cu",
        replaces="libiop_tpu/fields/prime.py:402", max_abs_err=err,
        **timing(lambda: lazy_reduce(F, lazy, True)),
        plain_ms=time_ms(lambda: lazy_sum_reduce_plain(F, lazy)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"lazy_sum_reduce ({L}, 2^{k + 4}) int64"))

    # K7: the main path's A z, B z, C z and A^T y
    A, B, C = cs_main.matrices()
    z = random_elems(F, cs_main.num_variables + 1, rng, dev)
    y = random_elems(F, cs_main.num_constraints, rng, dev)
    calls = []
    for M, seg, src, S, vec in ((A, A.rows, A.cols, A.num_rows, z),
                                (B, B.rows, B.cols, B.num_rows, z),
                                (C, C.rows, C.cols, C.num_rows, z),
                                (A, A.cols, A.rows, A.num_cols, y)):
        entry, src_flat, K = M._ell_plan(seg, src, S)
        calls.append((torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [M.vals, np.zeros((F.L, 1), np.int32)], axis=1))).to(dev),
            torch.from_numpy(entry).to(dev), torch.from_numpy(src_flat).to(dev),
            vec, K))
    err = max(max_abs_err(ell_matvec(F, *c), ell_matvec_plain(F, *c))
              for c in calls)
    # each entry: its value and two 32-bit indices; each product reads its
    # vector and writes its output once
    nnz = sum(len(M.rows) for M in (A, B, C, A))
    io = cs_main.num_constraints + cs_main.num_variables + 1
    bms, by = bound_ms(nnz * (ELEM_BYTES + 8) + 4 * io * ELEM_BYTES,
                       nnz * (MONT_OPS + ADDSUB_OPS))
    rows.append(dict(
        name="ell_matvec", route="cuda",
        source="libiop_tpu_torch/csrc/ell_matvec.cu",
        replaces="libiop_tpu/relations/sparse.py:87", max_abs_err=err,
        **timing(lambda: [ell_matvec(F, *c) for c in calls]),
        plain_ms=time_ms(lambda: [ell_matvec_plain(F, *c) for c in calls]),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"A z, B z, C z, A^T y at 2^{k} (nnz {nnz})"))

    if blake2b:
        # K3 on the zk round-0 leaves: 2^(k+2) leaves of 6 oracles x coset 4
        # x 6 words and a 32-byte salt (152 words, 608 bytes), 32-byte digests
        nl, nw = 1 << (k + 2), 6 * 4 * 6 + 8
        words = torch.from_numpy(rng.integers(0, 1 << 32, size=(nl, nw),
                                              dtype=np.uint64).astype(np.uint32)
                                 .view(np.int32)).to(dev)
        err = max_abs_err(blake2b_rows(words, 4 * nw, db, 0x00),
                          blake2b_rows_plain(words, 4 * nw, db, 0x00))
        ms = time_ms(lambda: blake2b_rows(words, 4 * nw, db, 0x00))
        plain = time_ms(lambda: blake2b_rows_plain(words, 4 * nw, db, 0x00),
                        reps=1, warmup=0)
        log(f"  blake2b_rows salted zk leaves 2^{k + 2} x 608 B err {err} kernel "
            f"{ms:.4f} ms plain {plain:.2f} ms")
        if err:
            raise AssertionError("blake2b_rows (salted leaves) disagrees with "
                                 "its twin")

    rows += check_ligero_kernels(F, dev, rng, k)
    for r in rows:
        r["field"] = F.name
        report(r)
    return rows


def check_ligero_kernels(F, dev, rng, k):
    """Phase 3, continued: K13 against its twin at the Aurora paths'
    placement (2^k values into 2^k columns) and at a map with sentinels
    (15/16 of 2^k values), K14 and K15 at Ligero's shapes at 2^k
    constraints in bench.py's configuration (the witness rows, the zk row
    blinding oracle), K15 also over 257 and 513 rows, where the 8-word
    accumulator folds.  K13's row comes from the paths' own call
    (check_recorded)."""
    rows = []
    ELEM_BYTES = elem_bytes(F)
    n = 1 << k
    errs = []
    for nv in (n, n - (n >> 4)):
        inv = np.full(n, nv, np.int64)
        inv[rng.permutation(n)[:nv]] = np.arange(nv)
        inv = torch.from_numpy(inv).to(dev)
        vals = random_elems(F, nv, rng, dev)
        errs.append(max_abs_err(k13.place_columns(vals, inv),
                                k13.place_columns_plain(vals, inv)))
    log(f"  place_columns ({F.L}, 2^{k}) and ({F.L}, {n - (n >> 4)}) into "
        f"2^{k} columns errs {errs}")
    if any(errs):
        raise AssertionError(f"place_columns ({F.name}) disagrees with its "
                             "plain twin")
    check_place_columns_edges(F, dev, rng)

    lp = ligero.LigeroIOPParams(F, 128, 2, 0.1, False, n, n - 1)
    H = MultiplicativeCoset(F, lp.systematic_domain_dim)
    D = MultiplicativeCoset(F, lp.codeword_domain_dim,
                            shift=F.multiplicative_generator)
    ext = MultiplicativeCoset(F, lp.systematic_domain_dim + 1)
    R, m, N = lp.num_oracles_input, H.order, D.order
    e = N // m
    x = random_elems(F, R * m, rng, dev).reshape(F.L, R, m)
    xe = random_elems(F, 2 * m, rng, dev).reshape(F.L, 1, 2 * m)
    err = max(max_abs_err(rs_encode(F, x, H, D), rs_encode_plain(F, x, H, D)),
              max_abs_err(rs_encode(F, xe, ext, D),
                          rs_encode_plain(F, xe, ext, D)))
    # the function's work, not the kernel's (which repeats the
    # interpolation for each of the e cosets): per row an inverse NTT of
    # size m, then e NTTs of size m, each after m scalings by
    # (1/m)(shift g^r)^j, a factor that does not depend on the row (so the
    # 1/m scaling costs nothing of its own); a butterfly's add and sub
    lg = m.bit_length() - 1
    bms, by = bound_ms(ELEM_BYTES * R * (m + N),
                       R * (((1 + e) * ntt_products(m) + e * m) * mont_ops(F)
                            + (1 + e) * m * lg * addsub_ops(F)))
    rows.append(dict(
        name="rs_encode", route="cuda", source="libiop_tpu_torch/csrc/rs_encode.cu",
        replaces="libiop_tpu/protocols/ligero.py:86", max_abs_err=err,
        **timing(lambda: rs_encode(F, x, H, D)),
        plain_ms=time_ms(lambda: rs_encode_plain(F, x, H, D)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"{R} rows of 2^{lg} -> 2^{N.bit_length() - 1}"))

    a = random_elems(F, R * N, rng, dev).reshape(F.L, R, N)
    b = random_elems(F, R * N, rng, dev).reshape(F.L, R, N)
    c = random_elems(F, R, rng, dev).reshape(F.L, R, 1)
    errs = [max_abs_err(row_dot(F, a, b), row_dot_plain(F, a, b)),
            max_abs_err(row_dot(F, a, c), row_dot_plain(F, a, c))]
    for deep in (257, 513):
        ad = random_elems(F, deep * 256, rng, dev).reshape(F.L, deep, 256)
        bd = random_elems(F, deep * 256, rng, dev).reshape(F.L, deep, 256)
        errs.append(max_abs_err(row_dot(F, ad, bd), row_dot_plain(F, ad, bd)))
    log(f"  row_dot errs (full, row scalars, 257 and 513 rows) {errs}")
    # per column R wide products, R wide adds (2W + 1 words) and one
    # reduction
    bms, by = bound_ms(ELEM_BYTES * (2 * R * N + N),
                       N * ((R + 1) * half_mont_ops(F)
                            + R * 2 * addsub_ops(F)))
    rows.append(dict(
        name="row_dot", route="cuda", source="libiop_tpu_torch/csrc/row_dot.cu",
        replaces="libiop_tpu/protocols/ligero.py:92", max_abs_err=max(errs),
        **timing(lambda: row_dot(F, a, b)),
        plain_ms=time_ms(lambda: row_dot_plain(F, a, b)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"{R} rows x 2^{N.bit_length() - 1}, full b"))
    return rows


#: phase 3's edge shapes of K13: (nv, n, kind); n and nv not multiples of
#: 4 (the scalar path and its tail), a sentinel-only map, a permutation
K13_EDGES = ((37, 103, "partial"), (4097, 4099, "partial"),
             (1000, 1024, "partial"), (0, 64, "sentinel"),
             (37, 100, "sentinel"), (1024, 1024, "permutation"))


def check_place_columns_edges(F, dev, rng):
    """Phase 3: K13 against its twin (exact) at K13_EDGES with int32 and
    int64 maps, each also as a view at an offset of one entry (not 16-byte
    aligned), one launch a call."""
    cases = 0
    for nv, n, kind in K13_EDGES:
        inv = np.full(n, nv, np.int64)
        if kind == "permutation":
            inv = rng.permutation(n)
        elif kind == "partial":
            inv[rng.permutation(n)[:nv]] = np.arange(nv)
        vals = random_elems(F, nv, rng, dev) if nv else \
            torch.zeros((F.L, 0), dtype=torch.int32, device=dev)
        for dtype in (torch.int32, torch.int64):
            whole = torch.from_numpy(np.concatenate([[nv], inv])).to(
                dtype).to(dev)
            for idx in (whole[1:].clone(), whole[1:]):
                before = kernels.LAUNCHES["place_columns"]
                got = k13.place_columns(vals, idx)
                if kernels.LAUNCHES["place_columns"] != before + 1:
                    raise AssertionError("place_columns did not launch K13")
                if not torch.equal(got, k13.place_columns_plain(vals, idx)):
                    raise AssertionError(
                        f"place_columns ({F.name}) disagrees with its twin "
                        f"at {nv} into {n} ({kind}, {dtype}, offset "
                        f"{idx.data_ptr() % 16} B)")
                if kind == "sentinel" and got.any():
                    raise AssertionError("place_columns: a sentinel-only "
                                         "map gave a nonzero column")
                cases += 1
    log(f"  place_columns edges ({F.L} limbs): {cases} cases equal")


def random_words(F, n, rng, dev):
    """n uniform GF(2^k) elements as (W, n) words (any k bits are one)."""
    return torch.from_numpy(rng.integers(0, 1 << 32, size=(F.W, n),
                                         dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def transform_launches(fn, m, W):
    """K17 launches one call of ``fn`` (a transform over 2^m) makes, read
    off LAUNCHES["additive_fft"]; fails unless they are the passes of
    additive_fft_plan(m, W)."""
    before = kernels.LAUNCHES["additive_fft"]
    fn()
    launches = kernels.LAUNCHES["additive_fft"] - before
    planned = len(additive_fft_plan(m, W))
    if launches != planned:
        raise AssertionError(f"additive_fft at 2^{m}, W {W}: {launches} "
                             f"launches, the plan has {planned} passes")
    return launches


#: log2 of the element count of phase 3's binary-field checks
BINARY_LOG_N = 20


def check_binary_kernels(dev, rng):
    """Phase 3, binary fields: K16 (product, square, inverse) over gf64 and
    gf192 on (W, 2^20), K17 forward and inverse over a shifted subspace of
    2^20 and K19 at eta = 1 on 2^20, gf192 (gf64 logged), against their
    twins, exact.  The kernels line takes the gf192 rows."""
    rows = []
    m = BINARY_LOG_N
    n = 1 << m
    for F in (gf64(), gf192()):
        W, eb = F.W, elem_bytes(F)
        a, b = random_words(F, n, rng, dev), random_words(F, n, rng, dev)
        a[:, 0] = 0
        errs = [max_abs_err(gf2k_mul(F, a, b), gf2k_mul_plain(F, a, b)),
                max_abs_err(gf2k_square(F, a), gf2k_square_plain(F, a)),
                max_abs_err(gf2k_inv(F, a), gf2k_inv_plain(F, a))]
        sq_ms = time_ms(lambda: gf2k_square(F, a))
        inv_ms = time_ms(lambda: gf2k_inv(F, a))
        sq_bound, _ = bound_ms(2 * eb * n, gf_square_ops(W) * n)
        inv_bound, _ = bound_ms(2 * eb * n, gf_batch_inv_ops(W) * n)
        log(f"  gf2k_mul {F.name} (W {W}, 2^{m}): errs (mul, square, inv) "
            f"{errs}; square {sq_ms:.4f} ms (bound {sq_bound:.4f}), inv "
            f"{inv_ms:.4f} ms (bound {inv_bound:.4f})")
        bms, by = bound_ms(3 * eb * n, gf_mul_ops(W) * n)
        rows.append(dict(
            name="gf2k_mul", route="cuda",
            source="libiop_tpu_torch/csrc/gf2k_mul.cu",
            replaces="libiop_tpu/fields/binary.py:249", max_abs_err=max(errs),
            **timing(lambda: gf2k_mul(F, a, b)),
            plain_ms=time_ms(lambda: gf2k_mul_plain(F, a, b)),
            bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
            shape=f"mul ({W}, 2^{m}) x ({W}, 2^{m})"))

        # K17: the FFT and the IFFT over x^m + span(x^0..x^(m-1))
        D = subspace.AffineSubspace(F, m, shift=1 << m)
        x = random_words(F, n, rng, dev)
        errs = []
        for inverse in (False, True):
            tw, sums = subspace.fft_tables(D, dev, inverse)
            errs.append(max_abs_err(additive_fft(F, x, tw, sums, inverse),
                                    additive_fft_plain(F, x, tw, sums,
                                                       inverse)))
        tw, sums = subspace.fft_tables(D, dev, False)
        # per level n twist products and n/2 unwind products; radix passes
        # of n/4 groups (3 XORs of W words each), m - 1 - j at level j
        passes = sum(max(0, m - 1 - j) for j in range(m))
        bms, by = bound_ms(eb * (2 * n + 3 * n),
                           m * (n + n // 2) * gf_mul_ops(W)
                           + passes * (n // 4) * 3 * W)
        log(f"  additive_fft {F.name} 2^{m} errs (fft, ifft) {errs}")
        rows.append(dict(
            name="additive_fft", route="cuda",
            source="libiop_tpu_torch/csrc/additive_fft.cu",
            replaces="libiop_tpu/algebra/subspace.py:172", max_abs_err=max(errs),
            **timing(lambda: additive_fft(F, x, tw, sums, False)),
            plain_ms=time_ms(lambda: additive_fft_plain(F, x, tw, sums, False),
                             reps=1, warmup=0),
            bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
            launches_per_transform=transform_launches(
                lambda: additive_fft(F, x, tw, sums, False), m, W),
            shape=f"FFT of 2^{m} over a shifted subspace"))

        # K19: eta = 1 at a random point and at a domain element
        Z = fri.localizer_vanishing(D, 1)
        offs = fri.coset_vanishing_offsets(D, 1, Z, dev)
        elems = D.elements(dev)
        errs = []
        for pt in (D.element_by_index_int(n // 3), F.random_ints(1, rng)[0]):
            args = (F, x, elems, offs, pt, Z.eval_at_point_int(pt),
                    F.inv_int(Z.epsilon), 2)
            errs.append(max_abs_err(fri_fold_additive(*args),
                                    fri_fold_additive_plain(*args)))
        # per element an inversion (batched) and a product, per coset two
        # products; reads the values, the elements and the offsets, writes
        # the fold
        bms, by = bound_ms(eb * (2 * n + n),
                           n * (gf_batch_inv_ops(W) + gf_mul_ops(W))
                           + (n // 2) * 2 * gf_mul_ops(W))
        rows.append(dict(
            name="fri_fold_additive", route="cuda",
            source="libiop_tpu_torch/csrc/fri_fold_additive.cu",
            replaces="libiop_tpu/protocols/fri.py:240", max_abs_err=max(errs),
            **timing(lambda: fri_fold_additive(*args)),
            plain_ms=time_ms(lambda: fri_fold_additive_plain(*args), reps=1,
                             warmup=0),
            bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
            shape=f"eta = 1, N = 2^{m} -> 2^{m - 1}"))
    for r in rows:
        report(r)
    return [r for r in rows if r["field"] == gf192().name]


def report(r):
    """Log a kernel row; fail if the kernel disagreed with its twin."""
    log(f"  {r['name']:13s} {r['field']:12s} {r['shape']:44s} err "
        f"{r['max_abs_err']} kernel {r['ms']:.4f} ms (a call "
        f"{r['call_ms']:.4f})  plain {r['plain_ms']:.2f} ms  bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    if r["max_abs_err"] != 0:
        raise AssertionError(f"{r['name']} ({r['field']}) disagrees with its "
                             "plain twin")


def add_library(r, library, name):
    """Time the one PyTorch call that computes row r's function on the same
    inputs, as the kernel is timed: library_ms device only, library_call_ms
    a single call."""
    t = timing(library)
    r["library_ms"], r["library_call_ms"] = t["ms"], t["call_ms"]
    log(f"  {r['name']:13s} {r['field']:12s} library {name} "
        f"{t['ms']:.4f} ms (a call {t['call_ms']:.4f}) against the kernel's "
        f"{r['ms']:.4f} ({r['call_ms']:.4f})")


def device_time_breakdown(fn, top=12):
    """Run fn under torch.profiler: wall seconds, summed device-kernel
    seconds (busy share = their ratio) and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    per_kernel = {}
    for ev in prof.events():
        dt = getattr(ev, "device_time", None)
        if dt is None:
            dt = getattr(ev, "cuda_time", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt:
            n, t = per_kernel.get(ev.name, (0, 0.0))
            per_kernel[ev.name] = (n + 1, t + dt / 1e6)
    busy = sum(t for _, t in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall else None,
            "top_kernels": [(name[:80], n, t) for name, (n, t) in ranked]}


def _golden_params(make_zk):
    return AuroraSnarkParams(
        security_parameter=32, RS_extra_dimensions=2,
        fri_localization_parameter=1, make_zk=make_zk, pow_bits=0,
        override_fri_queries=3, override_fri_interactive_repetitions=1,
        override_ldt_instances=1)


@contextlib.contextmanager
def seeded_salts(seed=7):
    """secrets.token_bytes drawn from default_rng(seed), as the zk golden
    test patches it for both packages."""
    real = secrets.token_bytes
    secrets.token_bytes = np.random.default_rng(seed).bytes
    try:
        yield
    finally:
        secrets.token_bytes = real


def host_time_breakdown(fn, top=15):
    """Run fn under cProfile: wall seconds (inflated by the profiler) and the
    functions with the most host time of their own."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.time() - t0
    stats = pstats.Stats(prof).stats
    ranked = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"wall_s": wall, "top_own_s": [
        (f"{os.path.basename(f)}:{line}:{name}", ncalls, round(own, 4),
         round(cum, 4))
        for (f, line, name), (_, ncalls, own, cum, _) in ranked]}


def golden(F, dev):
    """Phase 4: the golden configuration proven on the card, non-zk and zk."""
    cs, primary, aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(424242))
    for make_zk, want in ((False, GOLDEN_SHA256), (True, GOLDEN_ZK_SHA256)):
        params = _golden_params(make_zk)
        with seeded_salts():
            blob = aurora_snark_prover(cs, primary, aux, params,
                                       rng=np.random.default_rng(0),
                                       device=dev).serialize()
        digest = hashlib.sha256(blob).hexdigest()
        tag = "zk " if make_zk else ""
        log(f"  golden {tag}sha256 {digest}")
        if digest != want:
            raise AssertionError(f"golden {tag}transcript differs from the "
                                 "JAX package's")
        if not aurora_snark_verifier(cs, primary,
                                     BCSTranscript.deserialize(blob), params,
                                     device=dev):
            raise AssertionError(f"golden {tag}proof rejected")
        bad = bytearray(blob)
        bad[32] ^= 1  # first byte of the first Merkle root
        if aurora_snark_verifier(cs, primary,
                                 BCSTranscript.deserialize(bytes(bad)),
                                 params, device=dev):
            raise AssertionError(f"tampered golden {tag}proof accepted")
        wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
        if aurora_snark_verifier(cs, wrong, BCSTranscript.deserialize(blob),
                                 params, device=dev):
            raise AssertionError(f"golden {tag}proof accepted for a wrong "
                                 "primary input")
        log(f"  {tag}verify True; flipped byte rejected; wrong primary input "
            "rejected")


def golden_poseidon(dev):
    """Phase 4, continued: the JAX package's Poseidon Aurora configuration
    over alt_bn128_Fr proven on the card, in its three pinned cases."""
    F = alt_bn128_fr()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                             np.random.default_rng(77))
    for case, (hash_name, make_zk, want) in sorted(POSEIDON_PINS.items()):
        params = AuroraSnarkParams(
            security_parameter=32, RS_extra_dimensions=2,
            fri_localization_parameter=1, make_zk=make_zk,
            hash_name=hash_name, override_fri_queries=3,
            override_fri_interactive_repetitions=1, override_ldt_instances=1)
        with seeded_salts():
            blob = aurora_snark_prover(cs, primary, aux, params,
                                       rng=np.random.default_rng(78),
                                       device=dev).serialize()
        digest = hashlib.sha256(blob).hexdigest()
        log(f"  golden {case} sha256 {digest}")
        if digest != want:
            raise AssertionError(f"golden {case} transcript differs from the "
                                 "JAX package's")
        bad = bytearray(blob)
        bad[32] ^= 1  # first byte of the first Merkle root
        wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
        verdicts = [aurora_snark_verifier(cs, prim, BCSTranscript.deserialize(
            b), params, device=dev) for prim, b in ((primary, blob),
                                                     (primary, bytes(bad)),
                                                     (wrong, blob))]
        if verdicts != [True, False, False]:
            raise AssertionError(f"golden {case}: verifier gave {verdicts} "
                                 "for (proof, flipped byte, wrong input)")
        log(f"  {case} verify True; flipped byte rejected; wrong primary "
            "input rejected")


def golden_ligero(dev):
    """Phase 4, continued: the JAX package's Ligero SNARK configuration
    proven on the card, non-zk and zk."""
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                             np.random.default_rng(12345))
    for make_zk, want in sorted(LIGERO_PINS.items()):
        params = LigeroSnarkParams(
            security_parameter=32, RS_extra_dimensions=2, make_zk=make_zk,
            pow_bits=2, override_num_interactions=1, override_num_queries=4,
            override_ldt_instances=1)
        with seeded_salts():
            blob = ligero_snark_prover(cs, primary, aux, params,
                                       rng=np.random.default_rng(7),
                                       device=dev).serialize()
        digest = hashlib.sha256(blob).hexdigest()
        tag = "ligero zk" if make_zk else "ligero"
        log(f"  golden {tag} sha256 {digest}")
        if digest != want:
            raise AssertionError(f"golden {tag} transcript differs from the "
                                 "JAX package's")
        bad = bytearray(blob)
        bad[32] ^= 1  # first byte of the first Merkle root
        wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
        verdicts = [ligero_snark_verifier(cs, prim, BCSTranscript.deserialize(
            b), params, device=dev) for prim, b in ((primary, blob),
                                                     (primary, bytes(bad)),
                                                     (wrong, blob))]
        if verdicts != [True, False, False]:
            raise AssertionError(f"golden {tag}: verifier gave {verdicts} "
                                 "for (proof, flipped byte, wrong input)")
        log(f"  {tag} verify True; flipped byte rejected; wrong primary "
            "input rejected")


def golden_additive(dev):
    """Phase 4, continued: the JAX package's additive golden configuration
    over GF(2^64) proven on the card, non-zk and zk."""
    F = gf64()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                             np.random.default_rng(777))
    for make_zk, want in sorted(ADDITIVE_PINS.items()):
        params = _golden_params(make_zk)
        with seeded_salts():
            blob = aurora_snark_prover(cs, primary, aux, params,
                                       rng=np.random.default_rng(0),
                                       device=dev).serialize()
        digest = hashlib.sha256(blob).hexdigest()
        tag = "additive zk" if make_zk else "additive"
        log(f"  golden {tag} sha256 {digest}")
        if digest != want:
            raise AssertionError(f"golden {tag} transcript differs from the "
                                 "JAX package's")
        bad = bytearray(blob)
        bad[32] ^= 1  # first byte of the first Merkle root
        wrong = [primary[0] ^ 1] + list(primary[1:])
        verdicts = [aurora_snark_verifier(cs, prim, BCSTranscript.deserialize(
            b), params, device=dev) for prim, b in ((primary, blob),
                                                     (primary, bytes(bad)),
                                                     (wrong, blob))]
        if verdicts != [True, False, False]:
            raise AssertionError(f"golden {tag}: verifier gave {verdicts} "
                                 "for (proof, flipped byte, wrong input)")
        log(f"  {tag} verify True; flipped byte rejected; wrong primary "
            "input rejected")


def second_root_offset(blob):
    """The offset of the first byte of a transcript's second Merkle root
    (Fractal's first round-1 root: the verifier writes its own index roots
    over round 0's): the 20 header bytes, then per root its (round,
    domain) and length words and its bytes."""
    first_len = int.from_bytes(blob[28:32], "little")
    return 20 + 12 + first_len + 12


def golden_fractal(dev, calls):
    """Phase 4, continued: the JAX package's Fractal configurations
    (tests/test_fractal.py:63-98 over edwards_Fr, and
    tests/test_additive_aurora.py:139-157 over GF(2^64), whose kernel calls
    land in calls) indexed, proven and verified on the card, non-zk and
    zk: the index roots and the proof hash to the pins; a flipped index
    root, a flipped round-1 root and a wrong primary input are rejected."""
    configs = {
        "fractal": (edwards_fr(), 12345, dict(
            RS_extra_dimensions=1, pow_bits=2, override_fri_queries=4,
            override_lincheck_repetitions=1), 2, 3, FRACTAL_PINS),
        "fractal gf64": (gf64(), 51, dict(
            RS_extra_dimensions=2, override_fri_queries=3), None, 52,
            FRACTAL_ADDITIVE_PINS)}
    for case, (F, seed, extra, index_seed, prover_seed, pins) in \
            configs.items():
        cs, primary, aux = generate_r1cs_example(
            F, 16, 3, 15, np.random.default_rng(seed))
        for make_zk, (want_roots, want) in sorted(pins.items()):
            params = FractalSnarkParams(
                security_parameter=32, fri_localization_parameter=1,
                make_zk=make_zk, override_fri_interactive_repetitions=1,
                override_ldt_instances=1, **extra)
            index_rng = None if index_seed is None else \
                np.random.default_rng(index_seed)
            with kernel_calls(calls if F.kind == "additive" else {}):
                pidx, vidx = fractal_snark_indexer(cs, params, rng=index_rng,
                                                   device=dev)
                with seeded_salts():
                    blob = fractal_snark_prover(
                        cs, primary, aux, pidx, params,
                        rng=np.random.default_rng(prover_seed),
                        device=dev).serialize()
            roots = hashlib.sha256(b"".join(
                r for _, r in sorted(vidx.items()))).hexdigest()
            digest = hashlib.sha256(blob).hexdigest()
            tag = f"{case} zk" if make_zk else case
            log(f"  golden {tag} index roots sha256 {roots} proof sha256 "
                f"{digest}")
            if (roots, digest) != (want_roots, want):
                raise AssertionError(f"golden {tag}: index roots or proof "
                                     "differ from the JAX package's")
            bad_index = dict(vidx)
            key = sorted(bad_index)[0]
            bad_index[key] = bytes([bad_index[key][0] ^ 1]) + \
                bad_index[key][1:]
            bad = bytearray(blob)
            bad[second_root_offset(blob)] ^= 1
            wrong = [F.add_ints(primary[0], 1)] + list(primary[1:])
            verdicts = [fractal_snark_verifier(
                cs, prim, vi, BCSTranscript.deserialize(b), params,
                device=dev)
                for prim, vi, b in ((primary, vidx, blob),
                                    (primary, bad_index, blob),
                                    (primary, vidx, bytes(bad)),
                                    (wrong, vidx, blob))]
            if verdicts != [True, False, False, False]:
                raise AssertionError(f"golden {tag}: verifier gave "
                                     f"{verdicts} for (proof, flipped index "
                                     "root, flipped round-1 root, wrong "
                                     "input)")
            log(f"  {tag} verify True; flipped index root, flipped round-1 "
                "root and wrong primary input rejected")


def golden_ligero_41(dev, calls):
    """Phase 4, continued: the JAX package's Ligero configuration of
    tests/test_additive_aurora.py:114-137 over GF(2^64) (the repaired
    binary path; its K15 and K17 calls land in calls) and over alt_bn128_Fr
    with BLAKE2b and Poseidon."""
    fields = {"gf64": gf64, "alt_bn128": alt_bn128_fr}
    for case, (field, hash_name, want) in sorted(LIGERO_41_PINS.items()):
        F = fields[field]()
        cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                                 np.random.default_rng(41))
        params = LigeroSnarkParams(security_parameter=32,
                                   RS_extra_dimensions=2,
                                   height_width_ratio=1.0,
                                   hash_name=hash_name)
        with kernel_calls(calls if field == "gf64" else {}):
            blob = ligero_snark_prover(cs, primary, aux, params,
                                       rng=np.random.default_rng(42),
                                       device=dev).serialize()
        digest = hashlib.sha256(blob).hexdigest()
        log(f"  golden ligero {case} sha256 {digest}")
        if digest != want:
            raise AssertionError(f"golden ligero {case} transcript differs "
                                 "from the JAX package's")
        bad = bytearray(blob)
        bad[32] ^= 1
        wrong = [F.add_ints(primary[0], 1)] + list(primary[1:])
        verdicts = [ligero_snark_verifier(cs, prim, BCSTranscript.deserialize(
            b), params, device=dev) for prim, b in ((primary, blob),
                                                     (primary, bytes(bad)),
                                                     (wrong, blob))]
        if verdicts != [True, False, False]:
            raise AssertionError(f"golden ligero {case}: verifier gave "
                                 f"{verdicts}")
        log(f"  ligero {case} verify True; flipped byte and wrong primary "
            "input rejected")


#: the wrappers of K9-K15 as the main path calls them (module, name), the
#: record key, and the size of a call by which the largest one is kept; a
#: division is kept twice: the widest (most coefficients) and the deepest
#: (most blocks of h, which one thread per column walks in turn)
_RECORDED = [
    (poly, "horner", "horner", lambda F, coeffs, x: coeffs.numel() * x.shape[1]),
    (poly, "vanishing_divide", "vanishing_divide", lambda F, f, a, h: f.numel()),
    (poly, "vanishing_divide", "vanishing_divide_deep",
     lambda F, f, a, h: f.shape[1] // h),
    (poly, "vanishing_multiply", "vanishing_multiply",
     lambda F, f, neg_a, h: f.numel()),
    (domains, "powers", "powers", lambda F, x, n, start=None: n),
    (fri, "powers", "powers", lambda F, x, n, start=None: n),
    (k9, "poseidon_merkle_heap", "poseidon_merkle_heap",
     lambda bp, elems: elems.numel()),
    (k13, "place_columns", "place_columns",
     lambda values, inv: values[..., :1].numel() * (values.shape[-1]
                                                   + inv.numel())),
    (ligero, "rs_encode", "rs_encode",
     lambda F, values, src, dst: values.shape[1] * dst.order),
    (ligero, "row_dot", "row_dot", lambda F, a, b: a.numel()),
    (common, "row_dot", "row_dot", lambda F, a, b: a.numel()),
    # K2 as fft calls it: the most butterflies
    (alg_fft, "ntt_stages", "ntt_stages",
     lambda F, x, W, first_m: x.shape[1] * x.shape[2]
     * ((x.shape[2] // first_m).bit_length() - 1)),
    (alg_linearized, "linearized_divide", "linearized_divide",
     lambda F, f, terms, h: f.numel()),
    (alg_linearized, "linearized_divide", "linearized_divide_deep",
     lambda F, f, terms, h: f.shape[1] // max(1, h // 2)),
    (generic, "linearized_multiply", "linearized_multiply",
     lambda F, f, terms, h: f.numel()),
    (prime_mod, "batch_inv", "batch_inv", lambda F, a, c=None: a.numel()),
    (holographic_lincheck, "p_alpha_m", "p_alpha_m",
     lambda F, plans, p, r, inv, S: inv.numel()),
    (fri, "fri_fold_additive", "fri_fold_additive",
     lambda F, evals, elems, offsets, x, zv_x, eps_inv, c: evals.numel()),
    (subspace, "_k17", "additive_fft_batched",
     lambda F, S, tw, sums, inverse=False: S.numel() if S.ndim == 3 else -1),
    (sparse, "ell_matvec", "ell_matvec",
     lambda F, vals_pad, entry, src, vec, K: entry.numel()),
    (ldt_reducer, "ldt_combine", "ldt_combine",
     lambda F, inputs, coeffs, sub, tables: len(inputs) * inputs[0].shape[-1]),
    # K23 as ShardedNTT calls it; a shifted prologue beats an unshifted one
    (k23, "prologue", "four_step_prologue",
     lambda F, x, s, D, R, C, sp=None: 2 * x.shape[1] * R * C // D
     + (sp is not None)),
    (k23, "twiddle_pack", "four_step_twiddle",
     lambda F, a, s, D, W: a.numel()),
    (k23, "unpack", "four_step_unpack", lambda F, recv, R: recv.numel()),
    (k23, "epilogue", "four_step_epilogue", lambda F, g, C: g.numel())]


def _blake2b_shape(words, msg_bytes, digest_bytes, tag, out=None):
    return words.shape[0], words.shape[1], msg_bytes, digest_bytes, tag


def _powers_shape(F, x, n, start=None):
    return n, start is not None


#: wrappers whose calls are counted by shape: (module, name, record key,
#: the shape of a call); record[key][shape] = [calls, the first call's
#: args].  K17's transforms are thousands of small calls on the binary
#: paths: its most frequent shape is a row of its own; so are K3's, K11's
#: and K16's (check_frequent), whose other rows time a path's largest call
_COUNTED = [
    (subspace, "_k17", "additive_fft_shapes",
     lambda F, S, tw, sums, inverse=False: (
         S.shape[1] if S.ndim == 3 else 1, S.shape[-1], bool(inverse))),
    (bcs_common, "blake2b_rows", "blake2b_shapes", _blake2b_shape),
    (k3, "blake2b_rows", "blake2b_shapes", _blake2b_shape),
    (domains, "powers", "powers_shapes", _powers_shape),
    (fri, "powers", "powers_shapes", _powers_shape),
    (binary_mod, "gf2k_mul", "gf2k_shapes",
     lambda F, a, b: ("mul", tuple(a.shape), tuple(b.shape))),
    (binary_mod, "gf2k_square", "gf2k_shapes",
     lambda F, a: ("square", tuple(a.shape), None)),
    (binary_mod, "gf2k_inv", "gf2k_shapes",
     lambda F, a: ("inv", tuple(a.shape), None))]


@contextlib.contextmanager
def kernel_calls(record):
    """Keep, per record key, the arguments of the largest call of its
    wrapper in record[key] as (size, args), and count the calls of the
    _COUNTED wrappers by shape."""
    saved = []

    def counter(key, fn, shape_of):
        def counted(*args, **kw):
            entry = record.setdefault(key, {}).setdefault(
                shape_of(*args, **kw), [0, args + tuple(kw.values())])
            entry[0] += 1
            return fn(*args, **kw)
        return counted

    def spy(key, fn, size_of):
        def recorded(*args, **kw):
            size = size_of(*args, **kw)
            if size > record.get(key, (-1, None))[0]:
                record[key] = (size, args + tuple(kw.values()))
            return fn(*args, **kw)
        return recorded

    for mod, name, key, size_of in _RECORDED:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, spy(key, fn, size_of))
    for mod, name, key, shape_of in _COUNTED:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, counter(key, fn, shape_of))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def no_twin_on_cuda():
    """Make every plain twin raise if it is handed a CUDA tensor: on the
    card the main path must run the kernels only."""
    mods = [limbs] + [sys.modules[m] for m in sorted(sys.modules)
                      if m.startswith("libiop_tpu_torch.kernels.")]
    saved = []

    def on_cuda(a):
        if isinstance(a, (list, tuple)):
            return any(on_cuda(x) for x in a)
        return isinstance(a, torch.Tensor) and a.is_cuda

    def guard(name, fn):
        def checked(*args, **kw):
            if on_cuda(args):
                raise AssertionError(f"plain twin {name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return checked

    for mod in mods:
        for name, fn in list(vars(mod).items()):
            if name.endswith("_plain") and callable(fn):
                saved.append((mod, name, fn))
                setattr(mod, name, guard(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def fused_calls(record):
    """Count the runtime's fused-DAG calls and keep the one with the most
    tape ops (tape, inputs, scalars) in record."""
    real = runtime.fused_dag

    def spy(F, tape, inputs, scalars):
        record["calls"] = record.get("calls", 0) + 1
        best = record.get("tape")
        if best is None or len(tape.ops) > len(best[0].ops):
            record["tape"] = (tape, list(inputs), list(scalars))
        return real(F, tape, inputs, scalars)

    runtime.fused_dag = spy
    try:
        yield
    finally:
        runtime.fused_dag = real


#: the kernels a path does not run.  K6 (lazy_reduce) is on none: its one
#: main-path caller, the vanishing division's lazy suffix sums, is K12 now;
#: it stays the reduction of the sparse product's segment-sum fallback,
#: which these shapes do not take.  Aurora encodes no rows and sums none;
#: Ligero folds no codeword (its LDT is the direct one), divides by no
#: vanishing polynomial, places no columns, and evaluates its LDT's
#: combination in one K24 launch, not as a fused DAG.
_BINARY_KERNELS = {"gf2k_mul", "additive_fft", "linearized",
                   "fri_fold_additive", "ell_matvec_gf2", "horner_gf2",
                   "powers_gf2", "p_alpha_m_gf2"}
_FRACTAL_KERNELS = {"p_alpha_m", "p_alpha_m_gf2"}
#: K22 (the bivariate Lagrange evaluations) is on no SNARK's path: phase 16
#: drives it through BivariateLagrange.evaluations_over
_BIVARIATE_KERNELS = {"bivariate", "bivariate_gf2"}
#: K25 (the Lagrange basis of a domain at a point) is on no SNARK's path:
#: phase 21 drives it through lagrange_coefficients_any
_LAGRANGE_KERNELS = {"lagrange_coeffs", "lagrange_coeffs_gf2"}
#: K23 runs only under a codeword mesh (phases 17-19); K24 only on the
#: Ligero paths, whose LDT combination it is
FOUR_STEP_KERNELS = ("four_step_prologue", "four_step_twiddle",
                     "four_step_unpack", "four_step_epilogue")
_LDT_KERNELS = {"ldt_combine", "ldt_combine_gf2"}
#: on none of the unsharded SNARK paths
_ELSEWHERE = _BIVARIATE_KERNELS | _LAGRANGE_KERNELS | set(FOUR_STEP_KERNELS)
_NOT_ON_PATH = {
    "aurora_blake2b": {"poseidon", "lazy_reduce", "rs_encode", "row_dot"}
    | _BINARY_KERNELS | _FRACTAL_KERNELS | _ELSEWHERE | _LDT_KERNELS,
    "aurora_poseidon": {"blake2b_rows", "lazy_reduce", "rs_encode",
                        "row_dot"} | _BINARY_KERNELS | _FRACTAL_KERNELS
    | _ELSEWHERE | _LDT_KERNELS,
    "ligero": {"poseidon", "lazy_reduce", "fri_fold", "fused_dag",
               "vanishing", "place_columns", "batch_inv", "ldt_combine_gf2"}
    | _BINARY_KERNELS | _FRACTAL_KERNELS | _ELSEWHERE,
    # over a binary field K16-K19 and the GF(2^k) instantiations of K7,
    # K8, K10 and K11 take the prime kernels' places; the inverses are K16
    "aurora_binary": {"mont_mul", "ntt_stage", "fri_fold", "field_addsub",
                      "lazy_reduce", "ell_matvec", "poseidon", "horner",
                      "powers", "vanishing", "rs_encode", "row_dot",
                      "batch_inv"} | _FRACTAL_KERNELS | _ELSEWHERE
    | _LDT_KERNELS,
    # Fractal encodes no rows (no Ligero), evaluates no polynomial by
    # Horner (its lincheck's p_alpha is a closed form) and reduces no lazy
    # sum outside its kernels
    "fractal": {"poseidon", "lazy_reduce", "rs_encode", "row_dot", "horner"}
    | _BINARY_KERNELS | _ELSEWHERE | _LDT_KERNELS,
    # Fractal over GF(2^k): the binary kernels of Aurora's path but K10
    # (its lincheck's p_alpha is a closed form), and K21's GF(2^k)
    # instantiation
    "fractal_binary": {"mont_mul", "ntt_stage", "fri_fold", "field_addsub",
                       "lazy_reduce", "ell_matvec", "poseidon", "horner",
                       "powers", "vanishing", "rs_encode", "row_dot",
                       "batch_inv", "p_alpha_m", "horner_gf2"}
    | _ELSEWHERE | _LDT_KERNELS,
    # Ligero over GF(2^k): K16 products, K17 row encodes, K15 row sums,
    # BLAKE2b trees; its LDT is the direct one (no fold, no DAG)
    "ligero_binary": {"mont_mul", "ntt_stage", "fri_fold", "field_addsub",
                      "lazy_reduce", "ell_matvec", "fused_dag", "poseidon",
                      "horner", "powers", "vanishing", "place_columns",
                      "rs_encode", "linearized", "fri_fold_additive",
                      "batch_inv", "ldt_combine"} | _FRACTAL_KERNELS
    | _ELSEWHERE,
    # the FRI SNARK: random codewords (K2 with K1's shift and K11's tables),
    # one BLAKE2b tree a round (K3) and the folds (K4); no constraint
    # system, so no sparse product, DAG, vanishing polynomial or inverse
    "fri_snark": set(kernels.LAUNCHES) - {"mont_mul", "ntt_stage",
                                          "blake2b_rows", "fri_fold",
                                          "powers"}}

AURORA = (aurora_snark_prover, aurora_snark_verifier)
LIGERO = (ligero_snark_prover, ligero_snark_verifier)


def aurora_params(make_zk, hash_name, localization=2):
    """bench.py's Aurora configuration (bench.py:74-80; FRI localization
    1 for a binary field, bench.py:381-390)."""
    return AuroraSnarkParams(security_parameter=128, RS_extra_dimensions=2,
                             fri_localization_parameter=localization,
                             make_zk=make_zk, hash_name=hash_name,
                             pow_bits=20)


def ligero_params(make_zk):
    """bench.py's Ligero configuration (bench.py:195-240)."""
    return LigeroSnarkParams(security_parameter=128, RS_extra_dimensions=2,
                             height_width_ratio=0.1, make_zk=make_zk)


def fractal_params(make_zk, localization=2):
    """bench.py's Fractal configuration (bench.py:246-300; FRI localization
    1 for a binary field, as its aurora_gf192 stage)."""
    return FractalSnarkParams(security_parameter=128, RS_extra_dimensions=2,
                              fri_localization_parameter=localization,
                              make_zk=make_zk)


FRACTAL = (fractal_snark_indexer, fractal_snark_prover,
           fractal_snark_verifier)


def main_path(F, dev, cs, primary, aux, label, snark, params, seed, off_path,
              calls):
    """Phases 5-13: prove and verify with snark = (prover, verifier), or
    (indexer, prover, verifier) for Fractal, and params over F; the
    prover's rng is default_rng(seed) (None when seed is None).  The
    indexer runs first, timed apart, inside the counted run.  Every kernel
    outside ``off_path`` must be launched; the largest call of each
    recorded wrapper lands in calls."""
    indexer = snark[0] if len(snark) == 3 else None
    prover, verifier = snark[-2:]
    make_zk = params.make_zk
    rng = (lambda: None) if seed is None else (
        lambda: np.random.default_rng(seed))
    PROFILER.sync = True
    # the cold prove builds every table of its path, and the peak device
    # memory counts this path's tensors only: drop the memoized tables and
    # collect the provers of earlier paths (they sit in reference cycles
    # with their codewords until the cyclic collector runs); what is still
    # held (the recorded calls of earlier paths) is subtracted
    domains.clear_device_tables()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    record = {}
    index_s = None
    with no_twin_on_cuda(), kernel_calls(calls):
        kernels.reset_launch_counts()
        PROFILER.records.clear()
        if indexer is not None:
            t0 = time.time()
            pidx, vidx = indexer(cs, params, device=dev)
            torch.cuda.synchronize()
            index_s = time.time() - t0
            real_prover, real_verifier = prover, verifier

            def prover(cs, primary, aux, params, rng, device):
                return real_prover(cs, primary, aux, pidx, params, rng=rng,
                                   device=device)

            def verifier(cs, primary, transcript, params, device):
                return real_verifier(cs, primary, vidx, transcript, params,
                                     device=device)
        t0 = time.time()
        for k in runtime.DAG_ROUTES:
            runtime.DAG_ROUTES[k] = 0
        with fused_calls(record):
            proof = prover(cs, primary, aux, params, rng=rng(), device=dev)
        routes = dict(runtime.DAG_ROUTES)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
        launches_prove = dict(kernels.LAUNCHES)
        profile = PROFILER.report()
        blob = proof.serialize()
        record["blob"] = blob
        t0 = time.time()
        ok = verifier(cs, primary, BCSTranscript.deserialize(blob), params,
                      device=dev)
        torch.cuda.synchronize()
        verify_s = time.time() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    bad = bytearray(blob)
    # first byte of the first Merkle root; Fractal's verifier writes its
    # own index roots over round 0's, so there the first round-1 root
    bad[32 if indexer is None else second_root_offset(blob)] ^= 1
    tampered_ok = verifier(cs, primary, BCSTranscript.deserialize(bytes(bad)),
                           params, device=dev)
    wrong = [F.add_ints(primary[0], 1)] + list(primary[1:])
    wrong_ok = verifier(cs, wrong, BCSTranscript.deserialize(blob), params,
                        device=dev)
    # a second prove of the same system (tables and kernels already warm),
    # without block syncs, then a third under torch.profiler for the device
    # time by kernel
    PROFILER.sync = False
    t0 = time.time()
    blob2 = prover(cs, primary, aux, params, rng=rng(),
                   device=dev).serialize()
    torch.cuda.synchronize()
    warm_prove_s = time.time() - t0
    device_time = device_time_breakdown(
        lambda: prover(cs, primary, aux, params, rng=rng(), device=dev))
    host_time = host_time_breakdown(
        lambda: prover(cs, primary, aux, params, rng=rng(), device=dev))
    verify_host_time = host_time_breakdown(
        lambda: verifier(cs, primary, BCSTranscript.deserialize(blob), params,
                         device=dev))
    log(json.dumps({"stage": label, "field": F.name,
                    "hash": params.hash_name,
                    "log_n": int(cs.num_constraints).bit_length() - 1,
                    "index_s": index_s,
                    "prove_s": prove_s, "warm_prove_s": warm_prove_s,
                    "verify_s": verify_s, "verified": ok,
                    "flipped_byte_rejected": not tampered_ok,
                    "wrong_input_rejected": not wrong_ok,
                    "argument_bytes": len(blob),
                    "same_bytes_second_prove": blob2 == blob,
                    "max_memory_allocated": peak,
                    "peak_memory_of_path": peak - held, "launches": launches,
                    "launches_prove": launches_prove,
                    "fused_calls_prove": record.get("calls", 0),
                    "dag_routes_prove": routes,
                    "warm_prove_device_time": device_time,
                    "warm_prove_host_time": host_time,
                    "verify_host_time": verify_host_time,
                    "profile": [(d, nm, round(s, 6)) for d, nm, s in profile]}))
    if not ok:
        raise AssertionError(f"{label} proof rejected")
    if tampered_ok:
        raise AssertionError(f"{label}: tampered proof accepted")
    if wrong_ok:
        raise AssertionError(f"{label}: proof accepted for a wrong input")
    # zk proofs draw fresh salts, so only the non-zk bytes repeat
    if (blob2 == blob) == make_zk:
        raise AssertionError(f"{label}: second prove gave "
                             f"{'the same' if make_zk else 'different'} bytes")
    if launches_prove["fused_dag"] != record.get("calls", 0):
        raise AssertionError(f"{label}: {record.get('calls')} fused DAG calls "
                             f"but {launches_prove['fused_dag']} K8 launches")
    for name, count in launches.items():
        if count <= 0 and name not in off_path:
            raise AssertionError(f"kernel {name} was not launched on {label}")
    return launches, launches_prove, record


def check_fused_dag(F, record):
    """K8 against its twin on the largest DAG of a zk main path's prove
    (the fri_combine_inputs combination)."""
    tape, inputs, scalars = record["tape"]
    got = fused_dag(F, tape, inputs, scalars)
    want = fused_dag_plain(F, tape, inputs, scalars)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    n = inputs[0].shape[1]
    if F.kind == "additive":  # a GF(2^k) product; add and sub one XOR a word
        mul_ops, add_ops = gf_mul_ops(F.W), F.W
    else:
        mul_ops, add_ops = mont_ops(F), addsub_ops(F)
    bms, by = bound_ms(elem_bytes(F) * n * (tape.n_inputs + tape.n_outputs),
                       n * (tape.count(MUL) * mul_ops
                            + (tape.count(ADD) + tape.count(SUB)) * add_ops))
    row = dict(
        name="fused_dag", route="cuda",
        source="libiop_tpu_torch/csrc/fused_dag.cu",
        replaces="libiop_tpu/iop/runtime.py:366", max_abs_err=err,
        **timing(lambda: fused_dag(F, tape, inputs, scalars)),
        plain_ms=time_ms(lambda: fused_dag_plain(F, tape, inputs, scalars),
                         reps=3),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        shape=(f"{len(tape.ops)} ops ({tape.count(MUL)} mul), "
               f"{tape.n_inputs} inputs, {tape.n_regs} regs, n = 2^"
               f"{n.bit_length() - 1}"))
    report(row)
    return row


def poseidon_work(bp, k: int, n: int):
    """(products, (wide products, reductions), adds) of a Merkle tree of n
    leaves of k elements: each leaf ceil(k / rate) permutations and k
    absorbing adds, each of the n - 1 nodes one permutation and two adds; a
    permutation's S-boxes (square and multiply over alpha's bits) in every
    lane of a full round and one lane of a partial round, its round-key
    adds, and its mix: the MDS mat-vec as t^2 wide products summed lazily
    (t^2 wide adds) and t reductions, or the near-MDS adds (3 for t = 3, 7
    for t = 4)."""
    t, rounds = bp.t, bp.full_rounds + bp.partial_rounds
    sbox = bp.alpha.bit_length() - 1 + bin(bp.alpha).count("1") - 1
    prods = (bp.full_rounds * t + bp.partial_rounds) * sbox
    wide = redcs = 0
    adds = rounds * t
    if bp.near_mds:
        adds += rounds * (3 if t == 3 else 7)
    else:
        wide, redcs = rounds * t * t, rounds * t
        adds += rounds * t * t
    perms = n * -(-k // bp.rate) + (n - 1)
    return (perms * prods, perms * wide, perms * redcs,
            perms * adds + n * k + 2 * (n - 1))


#: the kernel each record key of _RECORDED belongs to
_RECORD_KERNEL = {"ntt_stages": "ntt_stage", "horner": "horner",
                  "powers": "powers",
                  "vanishing_divide": "vanishing",
                  "vanishing_divide_deep": "vanishing",
                  "vanishing_multiply": "vanishing",
                  "poseidon_merkle_heap": "poseidon",
                  "place_columns": "place_columns", "rs_encode": "rs_encode",
                  "row_dot": "row_dot"}


def check_recorded(F, calls, launched):
    """Phase 8: K2 and K9-K15 against their twins on the largest call of each
    that the paths over F made.  ``launched`` holds the kernels those paths
    launched; each of their record keys must be there (K9's only where a
    Poseidon path ran, K14's and K15's where a Ligero path ran), or the
    comparison would be lost without a sign.  K2 and K9-K13 give the
    kernels line's rows (K13's with index_select as its library call); K14 and
    K15, whose rows phase 3 gives, are logged."""
    missing = [key for key, name in _RECORD_KERNEL.items()
               if name in launched and key not in calls]
    if missing:
        raise AssertionError(f"{F.name}: no recorded call for {missing}")
    eb, mo, ao = elem_bytes(F), mont_ops(F), addsub_ops(F)
    rows = []

    def row(name, source, replaces, err, times, plain, nbytes, nops, shape):
        bms, by = bound_ms(nbytes, nops)
        r = dict(name=name, route="cuda", source=source, replaces=replaces,
                 max_abs_err=err, **times, plain_ms=plain, bound_ms=bms,
                 bound_by=by, library_ms=None, field=F.name, shape=shape)
        report(r)
        rows.append(r)

    # K2 on the paths' largest transform (the zk codeword), in place on a
    # copy of the recorded array (which holds that call's output)
    _, (_, xr, Wr, first_m) = calls["ntt_stages"]
    _, nrows, N = xr.shape
    x0 = xr.clone()
    want, plain_ms = timed_once(lambda: ntt_stages_plain(F, x0, Wr, first_m))
    buf = x0.clone()
    err = max_abs_err(ntt_stages(F, buf, Wr, first_m), want)
    del want
    row("ntt_stage", "libiop_tpu_torch/csrc/ntt.cu",
        "libiop_tpu/algebra/fft.py:103", err,
        timing(lambda: ntt_stages(F, buf, Wr, first_m)), plain_ms,
        *ntt_work(F, nrows, N, first_m),
        f"{nrows} row(s) of 2^{N.bit_length() - 1} from stage {first_m} in "
        f"{len(ntt_plan(N, first_m))} passes (the paths' largest call)")
    del x0, buf

    if "poseidon" in launched:
        bp, elems = calls["poseidon_merkle_heap"][1]
        _, k, n = elems.shape
        prods, wide, redcs, adds = poseidon_work(bp, k, n)
        want, plain_ms = timed_once(
            lambda: k9.poseidon_merkle_heap_plain(bp, elems))
        row("poseidon", "libiop_tpu_torch/csrc/poseidon.cu",
            "libiop_tpu/bcs/poseidon.py:263",
            max_abs_err(k9.poseidon_merkle_heap(bp, elems), want),
            timing(lambda: k9.poseidon_merkle_heap(bp, elems)), plain_ms,
            eb * (k * n + 2 * n),
            prods * mo + (wide + redcs) * half_mont_ops(F) + adds * ao,
            f"tree of 2^{n.bit_length() - 1} leaves x {k} elements "
            f"(alpha {bp.alpha})")

    _, (_, coeffs, x) = calls["horner"]
    d, k = coeffs.shape[1], x.shape[1]
    want, plain_ms = timed_once(lambda: horner_plain(F, coeffs, x))
    row("horner", "libiop_tpu_torch/csrc/horner.cu",
        "libiop_tpu/algebra/poly.py:184",
        max_abs_err(horner(F, coeffs, x), want),
        timing(lambda: horner(F, coeffs, x)), plain_ms,
        eb * (d + 2 * k), d * k * (mo + ao),
        f"d = {d} at {k} points (m, S = {blocking(d)})")

    _, (_, x, n, *start) = calls["powers"]
    start = start[0] if start else None
    row("powers", "libiop_tpu_torch/csrc/powers.cu",
        "libiop_tpu/algebra/domains.py:80",
        max_abs_err(powers(F, x, n, start), powers_plain(F, x, n, start)),
        timing(lambda: powers(F, x, n, start)),
        time_ms(lambda: powers_plain(F, x, n, start)),
        eb * (n + 2), n * mo, f"table of 2^{n.bit_length() - 1}")

    err, times, plain, nbytes, nops, shape = 0, [], 0.0, 0, 0, []
    for key in ("vanishing_divide", "vanishing_divide_deep"):
        _, (_, f, a, h) = calls[key]
        want, plain_ms = timed_once(
            lambda: vanishing_divide_plain(F, f, a, h))
        err = max(err, *(max_abs_err(g, w) for g, w in zip(
            vanishing_divide(F, f, a, h), want)))
        times.append(timing(lambda: vanishing_divide(F, f, a, h)))
        plain += plain_ms
        nb = f.shape[1] // h
        nbytes += eb * 2 * nb * h
        nops += (nb - 1) * h * (mo + ao)
        shape.append(f"divide {nb} x 2^{h.bit_length() - 1}")
    _, (_, g, neg_a, hm) = calls["vanishing_multiply"]
    err = max(err, max_abs_err(vanishing_multiply(F, g, neg_a, hm),
                               vanishing_multiply_plain(F, g, neg_a, hm)))
    times.append(timing(lambda: vanishing_multiply(F, g, neg_a, hm)))
    plain += time_ms(lambda: vanishing_multiply_plain(F, g, neg_a, hm))
    d = g.shape[1]
    nbytes += eb * (2 * d + hm)
    nops += d * (mo + ao)
    shape.append(f"multiply {d} by 2^{hm.bit_length() - 1}")
    shape = ", ".join(shape)
    row("vanishing", "libiop_tpu_torch/csrc/vanishing.cu",
        "libiop_tpu/algebra/poly.py:101", err, add_times(times), plain, nbytes,
        nops, shape)

    _, (values, inv) = calls["place_columns"]
    nv, n = values.shape[1], inv.numel()
    padded = torch.cat([values, values.new_zeros((F.L, 1))], dim=1)
    # each placed value read once with its int32 position, each column
    # written once
    row("place_columns", "libiop_tpu_torch/csrc/place_columns.cu",
        "libiop_tpu/algebra/generic.py:163",
        max_abs_err(k13.place_columns(values, inv),
                    k13.place_columns_plain(values, inv)),
        timing(lambda: k13.place_columns(values, inv)),
        time_ms(lambda: k13.place_columns_plain(values, inv)),
        eb * (nv + n) + 4 * nv, 0, f"({F.L}, {nv}) into {n} columns")
    add_library(rows[-1], lambda: torch.index_select(padded, 1, inv),
                "index_select")
    # the device-only time two ways: the spin-queued events (the row's ms)
    # and CUPTI's kernel durations
    rows[-1]["cupti_ms"] = cupti_ms(lambda: k13.place_columns(values, inv),
                                    n=DEVICE_MAX_CALLS)
    log(f"  place_columns {F.name:12s} device ms {rows[-1]['ms']:.4f} "
        f"({rows[-1]['ms_by']}), CUPTI {rows[-1]['cupti_ms']}")

    checks = []
    if "rs_encode" in launched:
        _, (_, rows_in, src, dst) = calls["rs_encode"]
        checks.append(("rs_encode", rs_encode, rs_encode_plain,
                       (F, rows_in, src, dst),
                       f"{rows_in.shape[1]} rows of {src.order} -> "
                       f"{dst.order}"))
    if "row_dot" in launched:
        _, (_, a, b) = calls["row_dot"]
        checks.append(("row_dot", row_dot, row_dot_plain, (F, a, b),
                       f"a {tuple(a.shape)}, b {tuple(b.shape)}"))
    for name, kernel, plain, args, shape in checks:
        err = max_abs_err(kernel(*args), plain(*args))
        log(f"  {name:13s} {F.name:12s} recorded {shape}: err {err} kernel "
            f"{time_ms(lambda: kernel(*args)):.4f} ms plain "
            f"{time_ms(lambda: plain(*args)):.2f} ms")
        if err:
            raise AssertionError(f"{name} ({F.name}) disagrees with its "
                                 "plain twin on a path's call")
    return rows


def check_fractal_recorded(F, calls):
    """Phase 12: K20 against its twin on the largest call the Fractal paths
    made and on that input with zeros written into it, and K21 on its
    largest call; each a row of the kernels line.  K20's bound counts three
    products an element (Montgomery's trick) and one more for a fused
    numerator; K21's one product a nonzero."""
    missing = [k for k in ("batch_inv", "p_alpha_m") if k not in calls]
    if missing:
        raise AssertionError(f"{F.name}: no recorded Fractal call for "
                             f"{missing}")
    eb, mo = elem_bytes(F), mont_ops(F)
    rows = []
    _, (_, a, *c) = calls["batch_inv"]
    c = c[0] if c else None
    zeroed = a.clone()
    zeroed[:, ::97] = 0
    n = a[0].numel()
    errs = [max_abs_err(batch_inv(F, x, c), batch_inv_plain(F, x, c))
            for x in (a, zeroed)]
    bms, by = bound_ms(eb * n * (3 if c is not None else 2),
                       n * mo * (4 if c is not None else 3))
    rows.append(dict(
        name="batch_inv", route="cuda",
        source="libiop_tpu_torch/csrc/batch_inv.cu",
        replaces="libiop_tpu/fields/prime.py:447", max_abs_err=max(errs),
        **timing(lambda: batch_inv(F, a, c)),
        plain_ms=time_ms(lambda: batch_inv_plain(F, a, c)),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        paths=("fractal_zk", "fractal"),
        shape=f"2^{n.bit_length() - 1} {'c/a' if c is not None else '1/a'}"
              f" (and with zeros)"))
    _, (_, plans, p, r, inv, S) = calls["p_alpha_m"]
    nnz = sum(plan[2].numel() for plan in plans)
    nv = inv.numel()
    # p read once, each nonzero's value and src once, each matrix's column
    # offsets, the placement and the output once
    bms, by = bound_ms(p.shape[1] * eb + nnz * (eb + 8)
                       + len(plans) * (S + 1) * 8 + nv * (eb + 8), nnz * mo)
    rows.append(dict(
        name="p_alpha_m", route="cuda",
        source="libiop_tpu_torch/csrc/p_alpha_m.cu",
        replaces="libiop_tpu/protocols/holographic_lincheck.py:134",
        max_abs_err=max_abs_err(p_alpha_m(F, plans, p, r, inv, S),
                                p_alpha_m_plain(F, plans, p, r, inv, S)),
        **timing(lambda: p_alpha_m(F, plans, p, r, inv, S)),
        plain_ms=time_ms(lambda: p_alpha_m_plain(F, plans, p, r, inv, S)),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        paths=("fractal_zk", "fractal"),
        shape=f"{len(plans)} matrices, {nnz} nonzeros, {nv} slots"))
    for row in rows:
        report(row)
    return rows


def check_ligero_binary_recorded(F, calls):
    """Phase 12, continued: K15's GF(2^k) instantiation and K17's batched
    transform against their twins on the largest calls the GF(2^64) Ligero
    path made; each a row of the kernels line."""
    missing = [k for k in ("row_dot", "additive_fft_batched")
               if k not in calls]
    if missing:
        raise AssertionError(f"{F.name}: no recorded Ligero call for "
                             f"{missing}")
    W, eb = F.W, elem_bytes(F)
    rows = []
    _, (_, a, b) = calls["row_dot"]
    _, R, N = a.shape
    bms, by = bound_ms(eb * (R * N + b[0].numel() + N),
                       R * N * (gf_mul_ops(W) - 16 * W + 2 * W) + N * 16 * W)
    rows.append(dict(
        name="row_dot", route="cuda", source="libiop_tpu_torch/csrc/row_dot.cu",
        replaces="libiop_tpu/protocols/ligero.py:92",
        max_abs_err=max_abs_err(row_dot(F, a, b), row_dot_plain(F, a, b)),
        **timing(lambda: row_dot(F, a, b)),
        plain_ms=time_ms(lambda: row_dot_plain(F, a, b)),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        shape=f"GF(2^{32 * W}) a {tuple(a.shape)}, b {tuple(b.shape)}"))
    _, (_, S, tw, sums, inverse) = calls["additive_fft_batched"]
    _, R, n = S.shape
    m = n.bit_length() - 1
    passes = sum(max(0, m - 1 - j) for j in range(m))
    bms, by = bound_ms(eb * 2 * R * n + eb * 3 * n,
                       R * (m * (n + n // 2) * gf_mul_ops(W)
                            + passes * (n // 4) * 3 * W))
    rows.append(dict(
        name="additive_fft", route="cuda",
        source="libiop_tpu_torch/csrc/additive_fft.cu",
        replaces="libiop_tpu/protocols/ligero.py:86",
        max_abs_err=max_abs_err(additive_fft(F, S, tw, sums, inverse),
                                additive_fft_plain(F, S, tw, sums, inverse)),
        **timing(lambda: additive_fft(F, S, tw, sums, inverse)),
        plain_ms=time_ms(lambda: additive_fft_plain(F, S, tw, sums, inverse),
                         reps=1, warmup=0),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        launches_per_transform=transform_launches(
            lambda: additive_fft(F, S, tw, sums, inverse), m, W),
        shape=f"{'IFFT' if inverse else 'FFT'} of {R} rows of 2^{m}"))
    for row in rows:
        report(row)
    return rows


def check_k17_frequent(F, calls):
    """Phase 13: K17 against its twin at the call shapes (rows, n,
    inverse) the GF(2^192) paths made most often (every shape tied at the
    top count), timed device-only: the rows the redesign order of K17
    rests on (its 2^20 row of phase 3 is the paths' largest call, not
    necessarily their usual one)."""
    shapes = calls["additive_fft_shapes"]
    top = max(count for count, _ in shapes.values())
    by_shape = {f"{k[0]}x2^{k[1].bit_length() - 1}{' inv' if k[2] else ''}":
                v[0] for k, v in sorted(shapes.items(),
                                        key=lambda kv: -kv[1][0])}
    W, eb = F.W, elem_bytes(F)
    rows = []
    for (R, n, inverse), (count, (_, S, tw, sums, _)) in sorted(
            shapes.items()):
        if count != top:
            continue
        m = n.bit_length() - 1
        passes = sum(max(0, m - 1 - j) for j in range(m))
        bms, by = bound_ms(eb * 2 * R * n + eb * 3 * n,
                           R * (m * (n + n // 2) * gf_mul_ops(W)
                                + passes * (n // 4) * 3 * W))
        r = dict(
            name="additive_fft", route="cuda",
            source="libiop_tpu_torch/csrc/additive_fft.cu",
            replaces="libiop_tpu/algebra/subspace.py:172",
            max_abs_err=max_abs_err(
                additive_fft(F, S, tw, sums, inverse),
                additive_fft_plain(F, S, tw, sums, inverse)),
            **timing(lambda: additive_fft(F, S, tw, sums, inverse)),
            plain_ms=time_ms(
                lambda: additive_fft_plain(F, S, tw, sums, inverse)),
            bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
            calls_of_shape=count, calls_by_shape=by_shape,
            launches_per_transform=transform_launches(
                lambda: additive_fft(F, S, tw, sums, inverse), m, W),
            shape=f"{'IFFT' if inverse else 'FFT'} of {R} row(s) of 2^{m}, "
                  f"{count} calls on the gf192 paths (their most frequent)")
        report(r)
        rows.append(r)
    return rows


def check_k19_recorded(F, calls):
    """Phase 13: K19 against its twin on the largest fold the GF(2^192)
    paths made (its phase-3 row folds a random 2^20 codeword)."""
    if "fri_fold_additive" not in calls:
        raise AssertionError(f"{F.name}: no recorded call for "
                             "fri_fold_additive")
    _, args = calls["fri_fold_additive"]
    _, v, elems, offs, x, zv_x, eps_inv, c = args
    W, N = v.shape
    eb, mo = elem_bytes(F), gf_mul_ops(W)
    bms, by = bound_ms(eb * (2 * N + 2 * (N // c)),
                       N * (gf_batch_inv_ops(W) + mo) + (N // c) * 2 * mo)
    r = dict(
        name="fri_fold_additive", route="cuda",
        source="libiop_tpu_torch/csrc/fri_fold_additive.cu",
        replaces="libiop_tpu/protocols/fri.py:240",
        max_abs_err=max_abs_err(fri_fold_additive(*args),
                                fri_fold_additive_plain(*args)),
        **timing(lambda: fri_fold_additive(*args)),
        plain_ms=time_ms(lambda: fri_fold_additive_plain(*args), reps=1,
                         warmup=0),
        bound_ms=bms, bound_by=by, library_ms=None, field=F.name,
        shape=f"eta = {c.bit_length() - 1}, N = 2^{N.bit_length() - 1}, the "
              "gf192 paths' largest fold")
    report(r)
    return [r]


#: the size of a _COUNTED shape, by which ties of the top count are broken
_SHAPE_SIZE = {
    "blake2b_shapes": lambda k: k[0] * k[1],
    "powers_shapes": lambda k: k[0],
    "gf2k_shapes": lambda k: max(math.prod(k[1]), math.prod(k[2] or (1,)))}


def _most_frequent(shapes, size):
    """(shape, calls, first call's args) of the most frequent shape, ties
    to the largest, and the ten most frequent shapes with their counts."""
    ranked = sorted(shapes.items(), key=lambda kv: (-kv[1][0], str(kv[0])))
    top = ranked[0][1][0]
    shape, (count, args) = max((kv for kv in ranked if kv[1][0] == top),
                               key=lambda kv: size(kv[0]))
    return shape, count, args, {str(k): v[0] for k, v in ranked[:10]}


def check_frequent(F, calls, keys):
    """K3, K11 and K16 against their twins at the shape the paths over F
    called them with most often (_COUNTED; ties to the largest), timed
    device-only: each a row beside its largest-call row, so that the
    redesign order rests on measured launches x gap."""
    rows = []
    W = F.L // 2 if F.kind != "additive" else F.W
    eb = elem_bytes(F)
    for key in keys:
        if key not in calls:
            raise AssertionError(f"{F.name}: no counted call for {key}")
        shape, count, args, by_shape = _most_frequent(
            calls[key], _SHAPE_SIZE[key])
        if key == "blake2b_shapes":
            words, msg, db, tag = args[:4]
            n = words.shape[0]
            kernel = lambda: blake2b_rows(words, msg, db, tag)  # noqa: E731
            plain = lambda: blake2b_rows_plain(words, msg, db, tag)  # noqa
            nbytes = n * (msg + db)
            nops = n * -(-(msg + 1) // 128) * BLAKE2B_BLOCK_OPS
            name, source, replaces = ("blake2b_rows",
                                      "libiop_tpu_torch/csrc/blake2b.cu",
                                      "libiop_tpu/bcs/device_blake2b.py:198")
            what = f"{n} rows of {msg} B -> {db} B (tag {tag})"
        elif key == "powers_shapes":
            _, x, n, *start = args
            start = start[0] if start else None
            binary = F.kind == "additive"
            twin = powers_gf2_plain if binary else powers_plain
            kernel = lambda: powers(F, x, n, start)  # noqa: E731
            plain = lambda: twin(F, x, n, start)  # noqa: E731
            nbytes = eb * (n + 2)
            nops = n * (gf_mul_ops(W) if binary else mont_ops(F))
            name = "powers_gf2" if binary else "powers"
            source, replaces = ("libiop_tpu_torch/csrc/powers.cu",
                                "libiop_tpu/algebra/domains.py:80")
            what = f"table of {n}" + (" from a start" if start is not None
                                      else "")
        else:
            op = shape[0]
            a = args[1]
            if op == "mul":
                b = args[2]
                kernel = lambda: gf2k_mul(F, a, b)  # noqa: E731
                plain = lambda: gf2k_mul_plain(F, a, b)  # noqa: E731
                n = math.prod(torch.broadcast_shapes(a.shape[1:],
                                                     b.shape[1:]))
                nbytes = eb * (a[0].numel() + b[0].numel() + n)
                nops = n * gf_mul_ops(W)
            else:
                fn, twin, per = ((gf2k_square, gf2k_square_plain,
                                  gf_square_ops(W)) if op == "square" else
                                 (gf2k_inv, gf2k_inv_plain,
                                  gf_batch_inv_ops(W)))
                kernel = lambda: fn(F, a)  # noqa: E731
                plain = lambda: twin(F, a)  # noqa: E731
                n = a[0].numel()
                nbytes, nops = eb * 2 * n, n * per
            name, source, replaces = ("gf2k_mul",
                                      "libiop_tpu_torch/csrc/gf2k_mul.cu",
                                      "libiop_tpu/fields/binary.py:249")
            what = f"{op} {shape[1]}" + (f" x {shape[2]}" if shape[2]
                                         else "")
        bms, by = bound_ms(nbytes, nops)
        r = dict(name=name, route="cuda", source=source, replaces=replaces,
                 max_abs_err=max_abs_err(kernel(), plain()), **timing(kernel),
                 plain_ms=time_ms(plain, reps=1, warmup=0), bound_ms=bms,
                 bound_by=by, library_ms=None, field=F.name,
                 calls_of_shape=count, calls_by_shape=by_shape,
                 shape=f"{what}, {count} calls (the paths' most frequent)")
        report(r)
        rows.append(r)
    return rows


def check_binary_recorded(F, calls):
    """Phase 10: K18 against its twin on the largest and the deepest
    division (most chunks of h/2: the blocked scan) and the largest product
    the binary paths gave it.  The paths must also have called K7, K10 and
    K11 (their GF(2^k) instantiations, held to their twins in phase 13)."""
    missing = [k for k in ("linearized_divide", "linearized_divide_deep",
                           "linearized_multiply", "ell_matvec", "horner",
                           "powers") if k not in calls]
    if missing:
        raise AssertionError(f"{F.name}: no recorded call for {missing}")
    eb, mo = elem_bytes(F), gf_mul_ops(F.W)
    err, times, plain, nbytes, nops, shape = 0, [], 0.0, 0, 0, []
    for key in ("linearized_divide", "linearized_divide_deep"):
        _, (_, f, terms, h) = calls[key]
        want, plain_ms = timed_once(
            lambda: linearized_divide_plain(F, f, terms, h))
        before = kernels.LAUNCHES["linearized"]
        err = max(err, *(max_abs_err(g, w) for g, w in zip(
            linearized_divide(F, f, terms, h), want)))
        launches = kernels.LAUNCHES["linearized"] - before
        times.append(timing(lambda: linearized_divide(F, f, terms, h)))
        plain += plain_ms
        d = f.shape[1]
        # each quotient coefficient: one product and XOR a term below x^h
        nbytes += eb * 2 * d
        nops += (d - h) * len(terms) * (mo + F.W)
        chunks = -(-(d - h) // max(1, h // 2))
        shape.append(f"divide {d} by 2^{h.bit_length() - 1} ({chunks} "
                     "chunks)")
    # the deep division on its own: the scan's segments and dependent steps
    # (two segment solves of B/(h/2) chunk steps and S - 1 carry steps)
    B = scan_segment(d, h)
    S = -(-(d - h) // B) if B else 0
    deep = dict(times[-1], launches=launches, segment=B, segments=S,
                dependent_steps=2 * B // max(1, h // 2) + S - 1 if B
                else chunks, shape=shape[-1])
    deep["bound_ms"], deep["bound_by"] = bound_ms(
        eb * 2 * d, (d - h) * len(terms) * (mo + F.W))
    log(f"  linearized deep division {json.dumps(deep)}")
    _, (_, g, terms_m, hm) = calls["linearized_multiply"]
    err = max(err, max_abs_err(linearized_multiply(F, g, terms_m, hm),
                               linearized_multiply_plain(F, g, terms_m, hm)))
    times.append(timing(lambda: linearized_multiply(F, g, terms_m, hm)))
    plain += time_ms(lambda: linearized_multiply_plain(F, g, terms_m, hm))
    d = g.shape[1]
    nbytes += eb * (2 * d + hm)
    nops += d * len(terms_m) * (mo + F.W)
    shape.append(f"multiply {d} by 2^{hm.bit_length() - 1}")
    bms, by = bound_ms(nbytes, nops)
    r = dict(name="linearized", route="cuda",
             source="libiop_tpu_torch/csrc/linearized.cu",
             replaces="libiop_tpu/algebra/linearized.py:88", max_abs_err=err,
             **add_times(times), plain_ms=plain, bound_ms=bms, bound_by=by,
             library_ms=None, field=F.name, shape=", ".join(shape),
             deep_division=deep)
    report(r)
    return [r]


def check_gf2_recorded(F, calls):
    """Phase 13: the GF(2^k) instantiations of K7, K10, K11 and K21 against
    their twins (exact) on the largest call each got on the paths over F;
    each a row of the kernels line.  Bounds count the work, not the
    designs: a comb product without its fold and an XOR a nonzero slot or
    a nonzero of K7 and K21, one fold an output (and K21's product by r_M
    a column and matrix); a product and an XOR a coefficient and point of
    K10, and its chunk combine; a product an element of K11."""
    missing = [k for k in ("ell_matvec", "horner", "powers", "p_alpha_m")
               if k not in calls]
    if missing:
        raise AssertionError(f"{F.name}: no recorded call for {missing}")
    W, eb, mo = F.W, elem_bytes(F), gf_mul_ops(F.W)
    acc_ops, fold_ops = mo - 16 * W + 2 * W, 16 * W
    rows = []

    def row(name, source, replaces, kernel, plain, nbytes, nops, shape,
            **extra):
        want, plain_ms = timed_once(plain)
        bms, by = bound_ms(nbytes, nops)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_abs_err(kernel(), want), **timing(kernel),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
            field=F.name, shape=shape, **extra))

    _, (_, vals, entry, src, vec, K) = calls["ell_matvec"]
    S = entry.numel() // K
    live = int((entry != vals.shape[1] - 1).sum())
    row("ell_matvec_gf2", "libiop_tpu_torch/csrc/ell_matvec.cu",
        "libiop_tpu/relations/sparse.py:87",
        lambda: ell_matvec(F, vals, entry, src, vec, K),
        lambda: ell_matvec_gf2_plain(F, vals, entry, src, vec, K),
        eb * (live + vec.shape[1] + S) + 16 * S * K,
        live * acc_ops + S * fold_ops,
        f"{S} rows x {K} slots ({live} nonzero), vec of {vec.shape[1]}")

    _, (_, coeffs, x) = calls["horner"]
    d, k = coeffs.shape[1], x.shape[1]
    m, S = blocking(d)
    row("horner_gf2", "libiop_tpu_torch/csrc/horner.cu",
        "libiop_tpu/algebra/poly.py:184",
        lambda: horner(F, coeffs, x),
        lambda: horner_gf2_plain(F, coeffs, x),
        eb * (d + 2 * k), (d + S) * k * (mo + W),
        f"d = {d} at {k} points (m, S = {m, S})")

    _, (_, xp, n, *start) = calls["powers"]
    start = start[0] if start else None
    row("powers_gf2", "libiop_tpu_torch/csrc/powers.cu",
        "libiop_tpu/algebra/domains.py:80",
        lambda: powers(F, xp, n, start),
        lambda: powers_gf2_plain(F, xp, n, start),
        eb * (n + 2), n * mo, f"table of {n}")

    _, (_, plans, p, r, inv, S) = calls["p_alpha_m"]
    nnz = sum(plan[2].numel() for plan in plans)
    nv = inv.numel()
    row("p_alpha_m_gf2", "libiop_tpu_torch/csrc/p_alpha_m.cu",
        "libiop_tpu/protocols/holographic_lincheck.py:134",
        lambda: p_alpha_m(F, plans, p, r, inv, S),
        lambda: p_alpha_m_gf2_plain(F, plans, p, r, inv, S),
        p.shape[1] * eb + nnz * (eb + 8) + len(plans) * (S + 1) * 8
        + nv * (eb + 8),
        nnz * acc_ops + len(plans) * S * (fold_ops + mo + W),
        f"{len(plans)} matrices, {nnz} nonzeros, {nv} slots",
        paths=("fractal_gf192_zk", "fractal_gf192"))
    for r_ in rows:
        report(r_)
    return rows


def fri_snark_params(log_degree):
    """The FRI-isolation configuration of the instrument's `--snark fri`
    (instrument.py run_fri: RS extra 2, BLAKE2b, 1 interactive repetition,
    10 queries, pow 0) with security 128, localization parameter 2 and four
    oracles, tested degree 2^log_degree (codeword 2^(log_degree + 2))."""
    return FRISnarkParams(security_parameter=128,
                          codeword_domain_dim=log_degree + 2,
                          RS_extra_dimensions=2, localization_parameter=2,
                          num_oracles=4, hash_name="blake2b", pow_bits=0,
                          override_fri_queries=10,
                          override_fri_interactive_repetitions=1)


def fri_path(F, dev, params, off_path):
    """Phase 14: the FRI SNARK (fri_snark_prover / fri_snark_verifier) on
    the card, prover rng default_rng(0): a cold prove from dropped device
    tables, verify, a proof with one Merkle root byte flipped (rejected),
    a warm prove (the same bytes), and further proves under torch.profiler
    and cProfile.  Every kernel outside ``off_path`` must be launched in the
    counted run (cold prove and verify); returns its launch counts."""
    rng = lambda: np.random.default_rng(0)  # noqa: E731
    PROFILER.sync = True
    domains.clear_device_tables()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with no_twin_on_cuda():
        kernels.reset_launch_counts()
        t0 = time.time()
        proof = fri_snark_prover(F, params, rng=rng(), device=dev)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
        launches_prove = dict(kernels.LAUNCHES)
        blob = proof.serialize()
        t0 = time.time()
        ok = fri_snark_verifier(F, BCSTranscript.deserialize(blob), params,
                                device=dev)
        torch.cuda.synchronize()
        verify_s = time.time() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    bad = BCSTranscript.deserialize(blob)
    key = sorted(bad.mt_roots)[0]
    root = bytearray(bad.mt_roots[key])
    root[0] ^= 1
    bad.mt_roots[key] = bytes(root)
    tampered_ok = fri_snark_verifier(F, bad, params, device=dev)
    PROFILER.sync = False
    t0 = time.time()
    blob2 = fri_snark_prover(F, params, rng=rng(), device=dev).serialize()
    torch.cuda.synchronize()
    warm_prove_s = time.time() - t0
    device_time = device_time_breakdown(
        lambda: fri_snark_prover(F, params, rng=rng(), device=dev))
    host_time = host_time_breakdown(
        lambda: fri_snark_prover(F, params, rng=rng(), device=dev))
    log(json.dumps({"stage": "fri_snark", "field": F.name,
                    "hash": params.hash_name,
                    "codeword_log": params.codeword_domain_dim,
                    "num_oracles": params.num_oracles,
                    "prove_s": prove_s, "warm_prove_s": warm_prove_s,
                    "verify_s": verify_s, "verified": ok,
                    "flipped_root_rejected": not tampered_ok,
                    "argument_bytes": len(blob),
                    "same_bytes_second_prove": blob2 == blob,
                    "max_memory_allocated": peak,
                    "peak_memory_of_path": peak - held, "launches": launches,
                    "launches_prove": launches_prove,
                    "warm_prove_device_time": device_time,
                    "warm_prove_host_time": host_time}))
    if not ok:
        raise AssertionError("fri_snark proof rejected")
    if tampered_ok:
        raise AssertionError("fri_snark: proof with a flipped root accepted")
    if blob2 != blob:
        raise AssertionError("fri_snark: second prove gave other bytes")
    for name, count in launches.items():
        if count <= 0 and name not in off_path:
            raise AssertionError(f"kernel {name} was not launched on fri_snark")
    return launches


def instrument_sweep(log_n):
    """Phase 15: the instrument CLI in process on the card, once per
    --snark choice at 2^log_n (its defaults: security 64, RS extra 3, FRI
    localization 2), with --detailed for fri; every line must say
    accepted: true, and the fri run must print the transcript report."""
    import io
    for snark in ("aurora", "fractal", "ligero", "fri"):
        argv = ["--device", "cuda", "--snark", snark, "--log_n_min",
                str(log_n), "--log_n_max", str(log_n)]
        if snark == "fri":
            argv.append("--detailed")
        buf = io.StringIO()
        with no_twin_on_cuda(), contextlib.redirect_stdout(buf):
            instrument.main(argv)
        out = buf.getvalue().splitlines()
        result = json.loads(out[-1])
        log(json.dumps({"stage": "instrument", **result}))
        if result["accepted"] is not True or result["device"] != "cuda":
            raise AssertionError(f"instrument --snark {snark}: {result}")
        if snark == "fri":
            report = [ln for ln in out[:-1] if ln.strip()]
            for ln in report:
                log(f"  {ln}")
            if not any(ln.startswith("IOP bytes:") for ln in report):
                raise AssertionError("instrument --detailed printed no report")


#: K22's cell: S of 2^16, L of 2^20 disjoint from S (a coset of the
#: multiplicative generator, or a subspace shifted by x^40)
BIVARIATE_LOG_S, BIVARIATE_LOG_L = 16, 20
#: the instrument sweep's size (phase 15)
INSTRUMENT_LOG_N = 8


def check_bivariate(F, dev, paths, log_s=BIVARIATE_LOG_S,
                    log_l=BIVARIATE_LOG_L):
    """Phase 16: BivariateLagrange(S).evaluations_over(x, L) on the card
    with x off L and x on L (the diagonal), from built device tables, with
    the launch counts set to 0 just before and read just after (one K22
    launch a call, no twin); each output against K22's plain twin on the
    same tables (exact), then K22 timed on the diagonal case.  Bound: the
    tables of y and Z_S(y) read once and the output written once; a
    subtraction for the numerator and one for the denominator, three
    products an element for the batched inverse (Montgomery's trick) and
    one by the numerator."""
    binary = F.kind == "additive"
    shift = (1 << 40) if binary else F.multiplicative_generator
    S = generic.make_domain(F, log_s)
    L = generic.make_domain(F, log_l, shift=shift)
    f = BivariateLagrange(S)
    ys = L.elements(dev)
    zy = generic.vanishing_evals_over_any(S, L, dev)
    points = {"outside": F.random_ints(1, np.random.default_rng(22))[0],
              "inside": L.element_by_index_int(L.order // 3)}
    label = f"bivariate_{F.name}"
    name = "bivariate_gf2" if binary else "bivariate"
    torch.cuda.synchronize()
    with no_twin_on_cuda():
        kernels.reset_launch_counts()
        outs = {tag: f.evaluations_over(x, L, dev)
                for tag, x in points.items()}
        torch.cuda.synchronize()
        paths[label] = dict(kernels.LAUNCHES)
    if paths[label][name] != len(points):
        raise AssertionError(f"{label}: {paths[label][name]} K22 launches "
                             f"for {len(points)} calls")
    err, plain_ms = 0, None
    for tag, x in points.items():
        args = (x, generic.vanishing_eval_int(S, x),
                generic.vanishing_derivative_int(S, x),
                index_of_element(L, x))
        want, plain_ms = timed_once(
            lambda: bivariate_evals_plain(F, ys, zy, *args))
        err = max(err, max_abs_err(outs[tag], want))
        if tag == "inside" and args[3] != L.order // 3:
            raise AssertionError(f"{label}: x on L found at {args[3]}")
    times = timing(lambda: bivariate_evals(F, ys, zy, *args))
    n, eb = L.order, elem_bytes(F)
    ops = (4 * gf_mul_ops(F.W) + 2 * F.W) if binary else \
        (4 * mont_ops(F) + 2 * addsub_ops(F))
    bms, by = bound_ms(3 * n * eb, n * ops)
    r = dict(name=name, route="cuda",
             source="libiop_tpu_torch/csrc/bivariate.cu",
             replaces="libiop_tpu/algebra/bivariate.py:72", max_abs_err=err,
             **times, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
             library_ms=None, field=F.name,
             shape=f"|S| 2^{log_s}, |L| 2^{log_l}, x off and on L",
             paths=(label,))
    report(r)
    return [r]


# -- phases 17-20: the four-step NTT, the sharded prover, K24 ---------------
#: the four-step phase's codeword, the shard counts it runs and the shards
#: of the sharded prover's in-process mesh
FOUR_STEP_LOG_N = 20
FOUR_STEP_SHARDS = (1, 2, 4, 8)
MESH_SHARDS = 4
#: seconds the two mesh worker processes get before both are killed
MESH_CHILD_TIMEOUT_S = 420


def four_step_ntt(F, dev, log_n=FOUR_STEP_LOG_N):
    """Phase 17: ShardedNTT at codeword 2^log_n over F on in-process meshes
    of D = 1, 2, 4, 8 shards on the card, shift 1 and a coset shift: its
    output equals fft's (K2) byte for byte; each of K23's four launch
    shapes on the plan's last shard equals its twin; ShardedNTT's ms and
    fft's side by side."""
    N = 1 << log_n
    coeffs = random_elems(F, N, np.random.default_rng(17), dev)
    for shift in (1, F.multiplicative_generator):
        dom = MultiplicativeCoset(F, log_n, shift)
        want = fft(coeffs, dom)
        fft_ms = time_ms(lambda: fft(coeffs, dom))
        for D in FOUR_STEP_SHARDS:
            ntt = ShardedNTT(dom, make_codeword_mesh(devices=[dev] * D))
            before = {k: kernels.LAUNCHES[k] for k in FOUR_STEP_KERNELS}
            same = torch.equal(ntt(coeffs), want)
            launched = {k: kernels.LAUNCHES[k] - before[k]
                        for k in FOUR_STEP_KERNELS}
            ms = time_ms(lambda: ntt(coeffs))
            errs = four_step_twins(F, ntt, coeffs, dev)
            log(json.dumps({"stage": "four_step_ntt", "field": F.name,
                            "log_n": log_n, "shift": shift != 1, "D": D,
                            "R": ntt.R, "C": ntt.C, "equals_fft": same,
                            "sharded_ntt_ms": ms, "fft_ms": fft_ms,
                            "k23_launches": launched,
                            "k23_max_abs_err": errs}))
            if not same:
                raise AssertionError(f"ShardedNTT over {D} shards differs "
                                     f"from fft ({F.name}, shift {shift})")
            if any(errs.values()):
                raise AssertionError(f"K23 disagrees with its twin: {errs}")
            if min(launched.values()) <= 0:
                raise AssertionError(f"ShardedNTT ran without K23: {launched}")


#: phase 17's small plans of K23's unpack and epilogue: (R, C, D, B), C/D
#: = 1, 2 and 4 and R = D, batches of 3
FOUR_STEP_MOVE_PLANS = ((64, 8, 8, 1), (64, 8, 4, 3), (64, 16, 4, 1),
                        (4, 64, 4, 3), (8, 8, 8, 3), (2, 4, 2, 1))


def four_step_moves(F, dev):
    """Phase 17: K23's unpack and epilogue against their twins (exact) on
    FOUR_STEP_MOVE_PLANS, the shapes of the sharded prove's small
    transforms (the 4-byte path), one launch a call."""
    rng = np.random.default_rng(23)
    for R, C, D, B in FOUR_STEP_MOVE_PLANS:
        RD, CD = R // D, C // D
        recv = random_elems(F, D * B * RD * CD, rng, dev).reshape(
            F.L, D, B, RD, CD).movedim(1, 0).contiguous()
        g = random_elems(F, D * B * CD * R, rng, dev).reshape(
            F.L, D, B, CD, R).movedim(1, 0).contiguous()
        for key, kernel, plain in (
                ("four_step_unpack", lambda: k23.unpack(F, recv, R),
                 lambda: k23.unpack_plain(recv, R)),
                ("four_step_epilogue", lambda: k23.epilogue(F, g, C),
                 lambda: k23.epilogue_plain(g, C))):
            before = kernels.LAUNCHES[key]
            got = kernel()
            if kernels.LAUNCHES[key] != before + 1:
                raise AssertionError(f"{key} did not launch K23")
            if not torch.equal(got, plain()):
                raise AssertionError(f"{key} ({F.name}) disagrees with its "
                                     f"twin at R {R}, C {C}, D {D}, B {B}")
    log(f"  K23 unpack and epilogue ({F.L} limbs) equal their twins at "
        f"(R, C, D, B) {list(FOUR_STEP_MOVE_PLANS)}")


def four_step_twins(F, ntt, coeffs, dev):
    """K23's four shapes against their twins as ShardedNTT gives them on
    its last shard (the received and gathered buffers stand in with the
    same shapes)."""
    D, R, C = ntt.D, ntt.R, ntt.C
    s = D - 1
    x = coeffs.reshape(F.L, 1, -1)
    sp = ntt.domain.shift_powers(dev) if ntt.domain.shift != 1 else None
    W = ntt.domain.generator_powers(dev)
    a = k23.prologue(F, x, s, D, R, C, sp)
    errs = {"four_step_prologue": max_abs_err(
        a, k23.prologue_plain(F, x, s, D, R, C, sp))}
    send = k23.twiddle_pack(F, a, s, D, W)
    errs["four_step_twiddle"] = max_abs_err(
        send, k23.twiddle_pack_plain(F, a, s, D, W))
    c = k23.unpack(F, send, R)
    errs["four_step_unpack"] = max_abs_err(c, k23.unpack_plain(send, R))
    g = c.expand((D,) + tuple(c.shape)).contiguous()
    errs["four_step_epilogue"] = max_abs_err(k23.epilogue(F, g, C),
                                             k23.epilogue_plain(g, C))
    return errs


def sharded_aurora(F, dev, cs, primary, aux, want_blob, calls):
    """Phase 18: the aurora cell's configuration proven under
    codeword_sharding_context of a MESH_SHARDS-shard mesh on the card: the
    bytes of phase 5's unsharded proof, the four-step route taken and each
    K23 shape launched (counts set to 0 just before the prove and read just
    after), no twin on a CUDA tensor; the proof verifies; a warm prove is
    timed; the golden configuration under the same mesh gives
    GOLDEN_SHA256.  Returns the prove's launch counts."""
    mesh = make_codeword_mesh(devices=[dev] * MESH_SHARDS)
    params = aurora_params(False, "blake2b")
    with no_twin_on_cuda(), kernel_calls(calls):
        kernels.reset_launch_counts()
        for k in SHARD_ROUTES:
            SHARD_ROUTES[k] = 0
        t0 = time.time()
        with codeword_sharding_context(mesh):
            blob = aurora_snark_prover(cs, primary, aux, params,
                                       device=dev).serialize()
        torch.cuda.synchronize()
        prove_s = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        routes = dict(SHARD_ROUTES)
    ok = aurora_snark_verifier(cs, primary, BCSTranscript.deserialize(blob),
                               params, device=dev)
    t0 = time.time()
    with codeword_sharding_context(mesh):
        blob2 = aurora_snark_prover(cs, primary, aux, params,
                                    device=dev).serialize()
    torch.cuda.synchronize()
    warm_prove_s = time.time() - t0
    g_cs, g_primary, g_aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(424242))
    with seeded_salts(), codeword_sharding_context(mesh):
        golden_digest = hashlib.sha256(aurora_snark_prover(
            g_cs, g_primary, g_aux, _golden_params(False),
            rng=np.random.default_rng(0), device=dev).serialize()).hexdigest()
    log(json.dumps({"stage": "aurora_sharded", "mesh": repr(mesh),
                    "prove_s": prove_s, "warm_prove_s": warm_prove_s,
                    "verified": ok, "argument_bytes": len(blob),
                    "equals_unsharded": blob == want_blob,
                    "warm_equals": blob2 == blob, "shard_routes": routes,
                    "golden_sha256": golden_digest,
                    "launches_prove": launches}))
    if blob != want_blob or blob2 != blob:
        raise AssertionError("the sharded Aurora proof differs from the "
                             "unsharded one")
    if not ok:
        raise AssertionError("the sharded Aurora proof was rejected")
    if routes["four_step"] <= 0:
        raise AssertionError(f"no transform took the four-step route: "
                             f"{routes}")
    missing = [k for k in FOUR_STEP_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the sharded prove launched no {missing}")
    if golden_digest != GOLDEN_SHA256:
        raise AssertionError("the golden configuration under the mesh "
                             "differs from the JAX package's")
    return launches


def run_children(cmds, timeout):
    """Run the commands concurrently; kill every one when any has not ended
    within ``timeout`` seconds (and fail).  Returns their stdouts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"mesh worker failed ({p.returncode}):\n"
                                     + err.decode(errors="replace")[-3000:])
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def two_process_aurora(log_n, want_digest, device="cuda:0"):
    """Phase 19: two ranks spawned with subprocess (this script with
    --mesh_rank), both on ``device`` with backend gloo and a file://
    rendezvous in a temporary directory, prove the aurora cell's
    configuration under make_global_codeword_mesh();
    assert_same_on_all_processes holds in the workers and their digest must
    equal the one-process proof's.  With two or more GPUs the same with
    backend nccl, one GPU a rank."""
    runs = [("gloo", [device, device])]
    gpus = torch.cuda.device_count()
    if gpus >= 2:
        runs.append(("nccl", ["cuda:0", "cuda:1"]))
    for backend, devices in runs:
        with tempfile.TemporaryDirectory() as td:
            rdv = os.path.join(td, "rendezvous")
            t0 = time.time()
            outs = run_children([
                [sys.executable, os.path.abspath(__file__), "--mesh_rank",
                 str(r), "--mesh_world", str(len(devices)), "--mesh_rdv", rdv,
                 "--mesh_backend", backend, "--mesh_device", d, "--log_n",
                 str(log_n)] for r, d in enumerate(devices)],
                MESH_CHILD_TIMEOUT_S)
            wall_s = time.time() - t0
        lines = [json.loads(next(ln for ln in o.splitlines()
                                 if ln.startswith("{\"mesh_worker\"")))
                 for o in outs]
        log(json.dumps({"stage": "aurora_two_process", "backend": backend,
                        "world_size": len(devices), "devices": devices,
                        "wall_s": wall_s, "workers": lines}))
        for w in lines:
            if w["digest"] != want_digest:
                raise AssertionError(f"rank {w['mesh_worker']} ({backend}) "
                                     "proved other bytes than the "
                                     "one-process proof")
            if w["shard_routes"]["four_step"] <= 0 or \
                    min(w["k23_launches"].values()) <= 0:
                raise AssertionError(f"rank {w['mesh_worker']} ({backend}) "
                                     "did not take the four-step route")
    if gpus < 2:
        log(f"  nccl: the NCCL run needs two GPUs ({gpus} present) and was "
            "not run")


def mesh_worker(args):
    """One rank of phase 19: join the process group, prove the aurora
    cell's configuration under the global mesh, check that every rank has
    the same digest, print one JSON line."""
    from datetime import timedelta
    from libiop_tpu_torch.parallel import multihost
    dev = torch.device(args.mesh_device)
    multihost.initialize("file://" + args.mesh_rdv, args.mesh_world,
                         args.mesh_rank, backend=args.mesh_backend,
                         device=dev, timeout=timedelta(seconds=300))
    F = edwards_fr()
    n = 1 << args.log_n
    cs, primary, aux = generate_r1cs_example(F, n, 15, n - 1,
                                             np.random.default_rng(0))
    mesh = multihost.make_global_codeword_mesh()
    kernels.reset_launch_counts()
    t0 = time.time()
    with no_twin_on_cuda(), codeword_sharding_context(mesh):
        blob = aurora_snark_prover(cs, primary, aux,
                                   aurora_params(False, "blake2b"),
                                   device=dev).serialize()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prove_s = time.time() - t0
    digest = hashlib.sha256(blob).hexdigest()
    multihost.assert_same_on_all_processes(bytes.fromhex(digest))
    print(json.dumps({"mesh_worker": args.mesh_rank, "mesh": repr(mesh),
                      "digest": digest, "prove_s": prove_s,
                      "shard_routes": dict(SHARD_ROUTES),
                      "k23_launches": {k: kernels.LAUNCHES[k]
                                       for k in FOUR_STEP_KERNELS}}),
          flush=True)
    multihost.shutdown()
    return 0


def check_four_step_recorded(F, calls):
    """Phase 18, continued: K23's four shapes against their twins on the
    largest call of each that the sharded prove made, timed; the rows of
    the kernels line.  Bound: bytes (each pass reads and writes its array
    once, plus the shift and twiddle table entries it needs) against one
    product an element on the prologue (with a shift) and the twiddle."""
    eb, mo = elem_bytes(F), mont_ops(F)
    rows = []

    def row(name, kernel, plain, nbytes, nops, shape, library=None):
        got = kernel()
        r = dict(name=name, route="cuda",
                 source="libiop_tpu_torch/csrc/four_step.cu",
                 replaces="libiop_tpu/parallel/shard_ntt.py:40",
                 max_abs_err=max_abs_err(got, plain()), **timing(kernel),
                 plain_ms=time_ms(plain), library_ms=None, field=F.name,
                 shape=shape, paths=("aurora_sharded",))
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, nops)
        report(r)
        if library is not None:
            add_library(r, *library)
        rows.append(r)

    _, (_, x, s, D, R, C, sp) = calls["four_step_prologue"]
    B, d = x.shape[1], x.shape[2]
    RD = R // D
    j = (s * RD + torch.arange(RD)[:, None]
         + R * k23.bitrev(C, "cpu")[None, :])
    valid = int((j < d).sum())
    tables = valid if sp is not None else 0
    row("four_step_prologue", lambda: k23.prologue(F, x, s, D, R, C, sp),
        lambda: k23.prologue_plain(F, x, s, D, R, C, sp),
        eb * (B * valid + tables + B * RD * C), B * tables * mo,
        f"shard {s} of {D}: ({B}, {d}) -> ({B}, {RD}, {C})"
        + (", shifted" if sp is not None else ""))

    _, (_, a, s, D, W) = calls["four_step_twiddle"]
    B, RD, C = a.shape[1:]
    N = W.shape[1]
    idx = ((s * RD + torch.arange(RD))[:, None] * torch.arange(C)[None, :]) % N
    twiddles = int(torch.unique(idx).numel())
    row("four_step_twiddle", lambda: k23.twiddle_pack(F, a, s, D, W),
        lambda: k23.twiddle_pack_plain(F, a, s, D, W),
        eb * (2 * B * RD * C + twiddles), B * RD * C * mo,
        f"shard {s} of {D}: ({B}, {RD}, {C}) -> ({D}, {B}, {RD}, {C // D})")

    _, (_, recv, R) = calls["four_step_unpack"]
    D, _, B, RD, CD = recv.shape
    flat = k23.unpack_plain(
        torch.arange(recv.numel(), device=recv.device, dtype=torch.int64
                     ).reshape(recv.shape), R).reshape(-1)
    row("four_step_unpack", lambda: k23.unpack(F, recv, R),
        lambda: k23.unpack_plain(recv, R), eb * 2 * B * R * CD, 0,
        f"({D}, {B}, {RD}, {CD}) -> ({B}, {CD}, {R})",
        library=(lambda: torch.take(recv, flat), "take"))

    _, (_, g, C) = calls["four_step_epilogue"]
    D, _, B, CD, R = g.shape
    row("four_step_epilogue", lambda: k23.epilogue(F, g, C),
        lambda: k23.epilogue_plain(g, C), eb * 2 * B * R * C, 0,
        f"({D}, {B}, {CD}, {R}) -> ({B}, {R * C})",
        library=(lambda: g.permute(1, 2, 4, 0, 3).contiguous(),
                 "permute().contiguous()"))
    return rows


def check_ldt_combine(dev, paths, prime_call, binary_call):
    """Phase 20: K24 on the Ligero paths: at least one launch on ligero,
    ligero_zk (ldt_combine) and ligero_gf64 (ldt_combine_gf2); K24 against
    its twin on the largest call each path family made (and the 8-word
    instantiation over alt_bn128_Fr at the edwards call's shape, random
    inputs); the Ligero pins of phase 4 proven again, with K24 launched.
    Bound: the n inputs and the x^Delta tables read once and the output
    written once, against n products and n - 1 additions an element (wide
    products summed and one reduction, as K15's row; over GF(2^k) clmuls
    XORed and one fold), and a product and an addition for each
    submaximal coefficient."""
    for label, key in (("ligero", "ldt_combine"), ("ligero_zk", "ldt_combine"),
                       ("ligero_gf64", "ldt_combine_gf2")):
        if paths[label][key] <= 0:
            raise AssertionError(f"{label} launched no {key}")
    rows = []
    Fb = alt_bn128_fr()
    _, (F, inputs, coeffs, sub, tables) = prime_call
    n, N = len(inputs), inputs[0].shape[-1]
    rng = np.random.default_rng(20)
    bn = Fb.from_ints(Fb.random_ints(n * N, rng), dev).reshape(Fb.L, n, N)
    bn_tables = {}
    for t in tables:
        if t is not None and t.data_ptr() not in bn_tables:
            bn_tables[t.data_ptr()] = random_elems(Fb, N, rng, dev)
    cases = [(F, inputs, coeffs, sub, tables, ("ligero_zk", "ligero")),
             (Fb, [bn[:, k] for k in range(n)], Fb.random_ints(n, rng),
              [None if c is None else Fb.random_ints(1, rng)[0] for c in sub],
              [None if t is None else bn_tables[t.data_ptr()]
               for t in tables], ("ligero_zk", "ligero"))]
    _, (Fl, *args) = binary_call
    cases.append((Fl, *args, ("ligero_gf64",)))
    for Fx, inputs, coeffs, sub, tables, on in cases:
        n, N = len(inputs), inputs[0].shape[-1]
        ns = sum(t is not None for t in tables)
        distinct = len({t.data_ptr() for t in tables if t is not None})
        binary = Fx.kind == "additive"
        if binary:  # n clmuls XORed (2W words), one fold; c' x^Delta
            W = Fx.W
            clmul = gf_mul_ops(W) - 16 * W
            ops = (n * clmul + (n - 1) * 2 * W + 16 * W
                   + ns * (gf_mul_ops(W) + W))
        else:  # n wide products and adds (2W + 1 words), one reduction
            ops = ((n + 1) * half_mont_ops(Fx) + (n - 1) * 2 * addsub_ops(Fx)
                   + ns * (mont_ops(Fx) + addsub_ops(Fx)))
        bms, by = bound_ms(elem_bytes(Fx) * N * (n + distinct + 1), N * ops)
        args = (Fx, inputs, coeffs, sub, tables)
        r = dict(name="ldt_combine_gf2" if binary else "ldt_combine",
                 route="cuda", source="libiop_tpu_torch/csrc/ldt_combine.cu",
                 replaces="libiop_tpu/protocols/ldt_reducer.py:105",
                 max_abs_err=max_abs_err(ldt_combine(*args),
                                         ldt_combine_plain(*args)),
                 **timing(lambda: ldt_combine(*args)),
                 plain_ms=time_ms(lambda: ldt_combine_plain(*args)),
                 bound_ms=bms, bound_by=by, library_ms=None, field=Fx.name,
                 shape=f"{n} inputs ({ns} submaximal, {distinct} tables) of "
                       f"{N}", paths=on)
        report(r)
        rows.append(r)
    kernels.reset_launch_counts()
    golden_ligero(dev)
    golden_ligero_41(dev, {})
    pins = {k: kernels.LAUNCHES[k] for k in ("ldt_combine", "ldt_combine_gf2")}
    log(f"  the Ligero pins hold with K24: launches {pins}")
    if min(pins.values()) <= 0:
        raise AssertionError(f"the Ligero pins ran without K24: {pins}")
    return rows


# -- phase 21: K25, the Lagrange basis of a domain at a point --------------
#: K25's cell: H of 2^20 (the canonical subgroup, or the standard subspace)
LAGRANGE_LOG_H = 20
#: the microbench's lagrange suite in phase 21 (its own cap is 2^18)
LAGRANGE_BENCH_LOGS = (10, 18)


def lagrange_scal(F, H, alpha, dev):
    """The (L, 2) device buffer of alpha and zeta = Z_H(alpha) / c that
    lagrange_coefficients_any hands K25 (c = h s^(h-1) over a coset, eps
    over a subspace)."""
    if F.kind == "additive":
        c = generic.vanishing_derivative_int(H, alpha)
    else:
        c = F.mul_ints(H.order % F.p, F.pow_int(H.shift, H.order - 1))
    zeta = F.mul_ints(generic.vanishing_eval_int(H, alpha), F.inv_int(c))
    return F.from_ints([F.sample_int(alpha), zeta], dev)


def check_lagrange(F, dev, paths, log_h=LAGRANGE_LOG_H):
    """Phase 21: lagrange_coefficients_any(H, alpha) on the card with alpha
    off H and alpha on H, and over a prime field poly.lagrange_coefficients
    at alpha off H held on the device, from built device tables, with the
    launch counts set to 0 just before and read just after (one K25 launch
    a call, no twin); each output against K25's plain twin on the same
    tables (exact), the device-alpha route against the host-int one, then
    K25 timed off H.  Bound: the tables of h_k (and g^k over a coset) read
    once and the output written once; a subtraction an element, three
    products an element for the batched inverse (Montgomery's trick) and,
    over a coset, one by g^k."""
    binary = F.kind == "additive"
    H = generic.make_domain(F, log_h)
    hs = H.elements(dev)
    ws = None if binary else H.generator_powers(dev)
    points = {"off": F.random_ints(1, np.random.default_rng(23))[0],
              "on": H.element_by_index_int(H.order // 3)}
    alpha_dev = F.from_ints([points["off"]], dev).reshape(F.L)
    label = f"lagrange_{F.name}"
    name = "lagrange_coeffs_gf2" if binary else "lagrange_coeffs"
    torch.cuda.synchronize()
    with no_twin_on_cuda():
        kernels.reset_launch_counts()
        outs = {tag: generic.lagrange_coefficients_any(H, a, dev)
                for tag, a in points.items()}
        if not binary:
            outs["device_alpha"] = poly.lagrange_coefficients(H, alpha_dev)
        torch.cuda.synchronize()
        paths[label] = dict(kernels.LAUNCHES)
    if paths[label][name] != len(outs):
        raise AssertionError(f"{label}: {paths[label][name]} K25 launches "
                             f"for {len(outs)} calls")
    if "device_alpha" in outs and not torch.equal(outs["device_alpha"],
                                                  outs["off"]):
        raise AssertionError(f"{label}: poly.lagrange_coefficients differs "
                             "from lagrange_coefficients_any")
    onehot = torch.zeros(H.order, dtype=torch.bool, device=dev)
    onehot[H.order // 3] = True
    if not torch.equal(outs["on"], torch.where(
            onehot, F.ones((H.order,), dev), F.zeros((H.order,), dev))):
        raise AssertionError(f"{label}: alpha on H is not one-hot")
    err, plain_ms = 0, None
    for tag, a in points.items():
        scal = lagrange_scal(F, H, a, dev)
        want, t = timed_once(lambda: lagrange_coeffs_plain(F, hs, ws, scal))
        err = max(err, max_abs_err(outs[tag], want))
        if tag == "off":
            plain_ms, scal_off = t, scal
    times = timing(lambda: lagrange_coeffs(F, hs, ws, scal_off))
    n, eb = H.order, elem_bytes(F)
    ops = (3 * gf_mul_ops(F.W) + F.W) if binary else \
        (4 * mont_ops(F) + addsub_ops(F))
    bms, by = bound_ms((2 if binary else 3) * n * eb, n * ops)
    r = dict(name=name, route="cuda",
             source="libiop_tpu_torch/csrc/lagrange.cu",
             replaces="libiop_tpu/algebra/generic.py:320", max_abs_err=err,
             **times, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
             library_ms=None, field=F.name,
             shape=f"|H| 2^{log_h}, alpha off and on H", paths=(label,))
    report(r)
    return [r]


def lagrange_microbench(paths, logs=LAGRANGE_BENCH_LOGS):
    """Phase 21: the microbench's lagrange suite in process on the card
    (edwards_Fr and GF(2^64)); every line must parse and name the card,
    the lagrange_{multiplicative,additive}[_cached] lines must cover every
    size, and K25 must be launched."""
    import io
    argv = ["--device", "cuda", "--suite", "lagrange", "--log_min",
            str(logs[0]), "--log_max", str(logs[1])]
    buf = io.StringIO()
    with no_twin_on_cuda(), contextlib.redirect_stdout(buf):
        kernels.reset_launch_counts()
        microbench.main(argv)
        torch.cuda.synchronize()
        paths["microbench_lagrange"] = dict(kernels.LAUNCHES)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ln in lines:
        log(json.dumps({"stage": "microbench", **ln}))
    sizes = {1 << k for k in range(logs[0], logs[1] + 1)}
    for bench in ("lagrange_multiplicative", "lagrange_additive",
                  "lagrange_multiplicative_cached",
                  "lagrange_additive_cached"):
        got = {ln["n"] for ln in lines if ln["bench"] == bench}
        if got != sizes:
            raise AssertionError(f"microbench {bench}: sizes {sorted(got)}")
    if any(ln["device"] != "cuda" for ln in lines):
        raise AssertionError("microbench lagrange: a line off the card")
    launched = paths["microbench_lagrange"]
    if min(launched["lagrange_coeffs"], launched["lagrange_coeffs_gf2"]) < \
            2 * len(sizes):
        raise AssertionError(f"microbench lagrange: K25 launches "
                             f"{launched['lagrange_coeffs']} / "
                             f"{launched['lagrange_coeffs_gf2']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log_n", type=int, default=16)
    # one rank of phase 19's two-process prover (spawned by this script)
    ap.add_argument("--mesh_rank", type=int)
    ap.add_argument("--mesh_world", type=int)
    ap.add_argument("--mesh_rdv")
    ap.add_argument("--mesh_backend")
    ap.add_argument("--mesh_device")
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_worker(args)

    log("phase 1: device")
    if not torch.cuda.is_available():
        log("no CUDA device visible to torch")
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 2: build")
    from libiop_tpu_torch.bcs.native_blake2b import _load as load_native
    t0 = time.time()
    build.build_all(verbose=True)
    load_native()
    log(f"  build_s {time.time() - t0:.1f}")

    F, Fb = edwards_fr(), alt_bn128_fr()
    n = 1 << args.log_n
    t0 = time.time()
    cs, primary, aux = generate_r1cs_example(F, n, 15, n - 1,
                                             np.random.default_rng(0))
    cs_b, primary_b, aux_b = generate_r1cs_example(Fb, n, 15, n - 1,
                                                   np.random.default_rng(0))
    Fg = gf192()
    cs_g, primary_g, aux_g = generate_r1cs_example(Fg, n, 15, n - 1,
                                                   np.random.default_rng(0))
    log(f"  examples 2^{args.log_n} setup_s {time.time() - t0:.1f}")
    rng = np.random.default_rng(2024)
    log("phase 3: kernels against their plain twins")
    rows = check_kernels(F, dev, rng, cs)
    rows += check_kernels(Fb, dev, rng, cs_b, blake2b=False)
    rows += check_binary_kernels(dev, rng)

    log("phase 4: golden transcripts on the card")
    golden(F, dev)
    golden_poseidon(dev)
    golden_ligero(dev)
    golden_additive(dev)
    Fl = gf64()
    calls = {F.name: {}, Fb.name: {}, Fg.name: {}, Fl.name: {},
             "fractal": {}}
    golden_fractal(dev, calls[Fl.name])
    golden_ligero_41(dev, calls[Fl.name])

    paths = {}
    log(f"phase 5: Aurora main path at 2^{args.log_n} constraints")
    paths["aurora"], _, record = main_path(
        F, dev, cs, primary, aux, "aurora", AURORA,
        aurora_params(False, "blake2b"), None, _NOT_ON_PATH["aurora_blake2b"],
        calls[F.name])
    aurora_blob = record["blob"]
    del record

    log(f"phase 6: zk Aurora main path at 2^{args.log_n} constraints")
    paths["aurora_zk"], _, record = main_path(
        F, dev, cs, primary, aux, "aurora_zk", AURORA,
        aurora_params(True, "blake2b"), 0, _NOT_ON_PATH["aurora_blake2b"],
        calls[F.name])
    rows.append(check_fused_dag(F, record))
    del record

    log(f"phase 7: Aurora over alt_bn128_Fr with Poseidon at "
        f"2^{args.log_n} constraints, non-zk and zk")
    paths["aurora_bn128_poseidon"], _, _ = main_path(
        Fb, dev, cs_b, primary_b, aux_b, "aurora_bn128_poseidon", AURORA,
        aurora_params(False, "poseidon"), None,
        _NOT_ON_PATH["aurora_poseidon"], calls[Fb.name])
    paths["aurora_bn128_poseidon_zk"], _, record = main_path(
        Fb, dev, cs_b, primary_b, aux_b, "aurora_bn128_poseidon_zk", AURORA,
        aurora_params(True, "poseidon"), 0, _NOT_ON_PATH["aurora_poseidon"],
        calls[Fb.name])
    rows.append(check_fused_dag(Fb, record))
    del record

    log(f"phase 8: Ligero at 2^{args.log_n} constraints, non-zk and zk")
    for make_zk, label in ((False, "ligero"), (True, "ligero_zk")):
        paths[label], _, _ = main_path(
            F, dev, cs, primary, aux, label, LIGERO, ligero_params(make_zk),
            1, _NOT_ON_PATH["ligero"], calls[F.name])
    field_paths = {F.name: ("aurora_zk", "ligero_zk", "aurora", "ligero"),
                   Fb.name: ("aurora_bn128_poseidon_zk",
                             "aurora_bn128_poseidon")}
    for Fx in (F, Fb):
        launched = {k for p in field_paths[Fx.name]
                    for k, c in paths[p].items() if c > 0}
        rows += check_recorded(Fx, calls[Fx.name], launched)
    rows += check_frequent(F, calls[F.name], ("blake2b_shapes",
                                              "powers_shapes"))

    log(f"phase 9: Aurora over GF(2^192) at 2^{args.log_n} constraints")
    paths["aurora_gf192"], _, _ = main_path(
        Fg, dev, cs_g, primary_g, aux_g, "aurora_gf192", AURORA,
        aurora_params(False, "blake2b", localization=1), None,
        _NOT_ON_PATH["aurora_binary"], calls[Fg.name])

    log(f"phase 10: zk Aurora over GF(2^192) at 2^{args.log_n} constraints")
    paths["aurora_gf192_zk"], _, record = main_path(
        Fg, dev, cs_g, primary_g, aux_g, "aurora_gf192_zk", AURORA,
        aurora_params(True, "blake2b", localization=1), 0,
        _NOT_ON_PATH["aurora_binary"], calls[Fg.name])
    rows.append(check_fused_dag(Fg, record))
    del record
    rows += check_binary_recorded(Fg, calls[Fg.name])
    field_paths[Fg.name] = ("aurora_gf192_zk", "aurora_gf192")

    log(f"phase 11: Fractal at 2^{args.log_n} constraints, indexer apart, "
        "non-zk and zk")
    paths["fractal"], _, _ = main_path(
        F, dev, cs, primary, aux, "fractal", FRACTAL, fractal_params(False),
        1, _NOT_ON_PATH["fractal"], calls["fractal"])
    paths["fractal_zk"], _, record = main_path(
        F, dev, cs, primary, aux, "fractal_zk", FRACTAL, fractal_params(True),
        1, _NOT_ON_PATH["fractal"], calls["fractal"])
    rows.append(check_fused_dag(F, record) | {"paths": ("fractal_zk",)})
    del record

    # one size below the other cells: its verify's host GF(2^64) products
    # (~6 s at 2^16, run four times) would cost the run ~15 s more
    log(f"phase 12: Ligero over GF(2^64) at 2^{args.log_n - 1} constraints")
    cs_l, primary_l, aux_l = generate_r1cs_example(
        Fl, n // 2, 15, n // 2 - 1, np.random.default_rng(0))
    paths["ligero_gf64"], _, _ = main_path(
        Fl, dev, cs_l, primary_l, aux_l, "ligero_gf64", LIGERO,
        ligero_params(False), 1, _NOT_ON_PATH["ligero_binary"], calls[Fl.name])
    del cs_l, primary_l, aux_l
    rows += check_fractal_recorded(F, calls["fractal"])
    rows += check_ligero_binary_recorded(Fl, calls[Fl.name])
    field_paths[Fl.name] = ("ligero_gf64",)

    log(f"phase 13: Fractal over GF(2^192) at 2^{args.log_n} constraints, "
        "indexer apart, non-zk and zk")
    for make_zk, label in ((False, "fractal_gf192"),
                           (True, "fractal_gf192_zk")):
        paths[label], _, record = main_path(
            Fg, dev, cs_g, primary_g, aux_g, label, FRACTAL,
            fractal_params(make_zk, localization=1), 1,
            _NOT_ON_PATH["fractal_binary"], calls[Fg.name])
    rows.append(check_fused_dag(Fg, record) | {"paths": ("fractal_gf192_zk",)})
    del record
    for Fx in (Fg, Fl):
        rows += check_gf2_recorded(Fx, calls[Fx.name])
    rows += check_k17_frequent(Fg, calls[Fg.name])
    rows += check_k19_recorded(Fg, calls[Fg.name])
    rows += check_frequent(Fg, calls[Fg.name], ("gf2k_shapes",
                                                "powers_shapes"))
    ldt_calls = (calls[F.name]["ldt_combine"], calls[Fl.name]["ldt_combine"])
    del calls

    log(f"phase 14: the FRI SNARK at degree 2^{args.log_n + 2}, codeword "
        f"2^{args.log_n + 4}, four oracles")
    paths["fri_snark"] = fri_path(F, dev, fri_snark_params(args.log_n + 2),
                                  _NOT_ON_PATH["fri_snark"])

    log("phase 15: the instrument sweep on the card")
    instrument_sweep(INSTRUMENT_LOG_N)

    log(f"phase 16: K22, the bivariate Lagrange evaluations, |S| "
        f"2^{BIVARIATE_LOG_S}, |L| 2^{BIVARIATE_LOG_L}")
    for Fx in (F, Fb, Fg, Fl):
        rows += check_bivariate(Fx, dev, paths)

    log(f"phase 17: the four-step NTT at codeword 2^{FOUR_STEP_LOG_N} over "
        f"{FOUR_STEP_SHARDS} shards on one card")
    for Fx in (F, Fb):
        four_step_ntt(Fx, dev)
        four_step_moves(Fx, dev)

    log(f"phase 18: the sharded Aurora prover at 2^{args.log_n} "
        f"constraints, {MESH_SHARDS} shards on one card")
    mesh_calls = {}
    paths["aurora_sharded"] = sharded_aurora(F, dev, cs, primary, aux,
                                             aurora_blob, mesh_calls)
    rows += check_four_step_recorded(F, mesh_calls)
    del mesh_calls

    log("phase 19: the sharded Aurora prover across two processes")
    two_process_aurora(args.log_n, hashlib.sha256(aurora_blob).hexdigest())

    log("phase 20: K24, the LDT combination, on the Ligero paths")
    rows += check_ldt_combine(dev, paths, *ldt_calls)
    del ldt_calls

    log(f"phase 21: K25, the Lagrange basis of a domain at a point, |H| "
        f"2^{LAGRANGE_LOG_H}, and the microbench's lagrange suite")
    for Fx in (F, Fb, Fg, Fl):
        rows += check_lagrange(Fx, dev, paths)
    lagrange_microbench(paths)

    log("phase 22: results")
    for r in rows:
        # the row's main path: the first of its field's paths (zk first),
        # or of the paths it names, that launched it
        cands = r.pop("paths", None) or field_paths[r["field"]]
        main = next((p for p in cands if paths[p][r["name"]] > 0), cands[0])
        r["main_path"] = main
        r["launches"] = paths[main][r["name"]]
        r["launches_by_path"] = {p: c[r["name"]] for p, c in paths.items()}
        r.pop("shape")
    for r in rows:
        r.setdefault("library_call_ms", None)
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
