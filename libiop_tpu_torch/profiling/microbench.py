"""Micro-benchmark suite (port of libiop_tpu/profiling/microbench.py): the
counterpart of the reference's google-benchmark binaries
(libiop/benchmarks/benchmark_{fft,hashes,lagrange,sumcheck,vector_op,
polynomials,gf64,gf128,gf192,gf256,edwards,alt_bn128}.cpp).

Where the reference times a scalar loop, the unit here is the batched
operation over a whole vector, on the card through the port's kernels;
rates are per element so the numbers stay comparable.  A developer tool:
nothing reads its lines as a metric.

Usage:
  python -m libiop_tpu_torch.profiling.microbench --suite fft --log_min 4 --log_max 16
  python -m libiop_tpu_torch.profiling.microbench --suite all --device cpu

Each case prints one JSON line:
  {"bench": "...", "n": N, "seconds": t, "per_s": rate, "device": "..."}
On the card t is the median of CUDA-event times of warm calls; on the CPU
the median of host times.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device


def _timeit(fn, dev, runs: int = 5) -> float:
    """Median seconds of fn() after one warm call: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    ts = []
    for _ in range(runs):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _once(fn, dev) -> float:
    """Host seconds of one call that ends in a device synchronize (for a
    call whose first run differs from the next, as a memoized one)."""
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _emit(args, bench: str, n: int, seconds: float):
    print(json.dumps({"bench": bench, "n": n, "seconds": seconds,
                      "per_s": n / max(seconds, 1e-12),
                      "device": str(args.dev)}), flush=True)


def _fields(names):
    from ..fields import binary
    from ..fields.prime import alt_bn128_fr, edwards_fr
    all_fields = {"edwards": edwards_fr, "alt_bn128": alt_bn128_fr,
                  "gf64": binary.gf64, "gf128": binary.gf128,
                  "gf192": binary.gf192, "gf256": binary.gf256}
    return {k: v() for k, v in all_fields.items() if k in names}


# -- field ops (benchmark_{edwards,alt_bn128,gf64,gf128,gf192,gf256}.cpp) ----

def suite_field(args):
    rng = np.random.default_rng(7)
    dev = args.dev
    for name, F in _fields(args.fields).items():
        for log_n in range(args.log_min, args.log_max + 1):
            n = 1 << log_n
            a = F.random((n,), rng, dev)
            b = F.random((n,), rng, dev)
            _emit(args, f"{name}_mul_vec", n,
                  _timeit(lambda: F.mul(a, b), dev))
            # data-dependency variant (BM_*_mul_vec_data_dependency): a
            # chain of k dependent products, timed per product
            k = 8
            _emit(args, f"{name}_mul_chain{k}", n,
                  _timeit(lambda: _mul_chain(F, a, b, k), dev) / k)
            if log_n <= 16:
                _emit(args, f"{name}_inverse_vec", n,
                      _timeit(lambda: F.inv(a), dev))


def _mul_chain(F, x, y, k):
    for _ in range(k):
        x = F.mul(x, y)
    return x


# -- FFT (benchmark_fft.cpp:18-175) ------------------------------------------

def suite_fft(args):
    from ..algebra.domains import MultiplicativeCoset
    from ..algebra.generic import fft_any, ifft_any
    from ..algebra.subspace import AffineSubspace
    rng = np.random.default_rng(7)
    dev = args.dev
    cases = []
    if "edwards" in args.fields:
        F = _fields(["edwards"])["edwards"]
        cases += [("multiplicative_subgroup", F,
                   lambda d, F=F: MultiplicativeCoset(F, d)),
                  ("multiplicative_coset", F,
                   lambda d, F=F: MultiplicativeCoset(
                       F, d, shift=F.multiplicative_generator))]
    if "gf64" in args.fields:
        G = _fields(["gf64"])["gf64"]
        cases += [("additive", G, lambda d, G=G: AffineSubspace(G, d))]
    for tag, F, mk in cases:
        for log_n in range(args.log_min, args.log_max + 1):
            dom = mk(log_n)
            coeffs = F.random((dom.order,), rng, dev)
            _emit(args, f"{tag}_FFT", dom.order,
                  _timeit(lambda: fft_any(coeffs, dom), dev))
            _emit(args, f"{tag}_IFFT", dom.order,
                  _timeit(lambda: ifft_any(coeffs, dom), dev))


# -- Lagrange (benchmark_lagrange.cpp:12-100) --------------------------------

def suite_lagrange(args):
    """The Lagrange basis of a domain at a point on the card (K25), then its
    repeat at the same point over the memoized domain tables
    (lagrange.hpp:21-55), and the unnormalized Lagrange basis over the
    domain (K22)."""
    from ..algebra.bivariate import BivariateLagrange
    from ..algebra.generic import lagrange_coefficients_any, make_domain
    rng = np.random.default_rng(7)
    dev = args.dev
    log_max = min(args.log_max, 18)
    for name in ("edwards", "gf64"):
        if name not in args.fields:
            continue
        F = _fields([name])[name]
        kind = F.kind
        for log_n in range(args.log_min, log_max + 1):
            dom = make_domain(F, log_n)
            alpha = F.random_ints(1, rng)[0]
            _emit(args, f"lagrange_{kind}", dom.order, _once(
                lambda: lagrange_coefficients_any(dom, alpha, dev), dev))
            _emit(args, f"lagrange_{kind}_cached", dom.order, _once(
                lambda: lagrange_coefficients_any(dom, alpha, dev), dev))
            f = BivariateLagrange(dom)
            _emit(args, f"bivariate_lagrange_{kind}", dom.order,
                  _timeit(lambda: f.evaluations_over(alpha, dom, dev), dev))


# -- hashes (benchmark_hashes.cpp:13-105) ------------------------------------

def suite_hashes(args):
    """BLAKE2b leaf digests of 1-16-element leaf blocks (K3) and Poseidon
    leaf hashes (K9), both variants."""
    from ..bcs.poseidon import PoseidonHashing
    from ..fields.prime import alt_bn128_fr
    from ..kernels.blake2b import blake2b_rows
    dev = args.dev
    n = 1 << min(args.log_max, 16)
    for k in (1, 2, 4, 8, 16):
        words = torch.zeros((n, 8 * k), dtype=torch.int32, device=dev)
        _emit(args, f"blake2b_leaf_{k}elem", n,
              _timeit(lambda: blake2b_rows(words, 32 * k, 32, 0), dev))
    F = alt_bn128_fr()
    nb = 1 << min(args.log_max, 12)
    for variant in ("poseidon", "poseidon_high_alpha"):
        h = PoseidonHashing(F, 128, variant)
        for k in (1, 2, 4):
            blocks = [bytes(F.elem_bytes * k) for _ in range(nb)]
            _emit(args, f"{variant}_leaf_{k}elem", nb,
                  _timeit(lambda: h.leaf_hash_batch(blocks, dev), dev))


# -- sumcheck (benchmark_sumcheck.cpp:51-125) --------------------------------

def suite_sumcheck(args):
    """Additive sumcheck prover over GF(2^64): the oracle-encoding step
    (IFFT over H, zero-pad, FFT over the codeword domain)."""
    from ..algebra.generic import fft_any, ifft_any
    from ..algebra.subspace import AffineSubspace
    from ..fields.binary import gf64
    F = gf64()
    rng = np.random.default_rng(7)
    dev = args.dev
    for log_n in range(max(args.log_min, 8), min(args.log_max, 18) + 1):
        H = AffineSubspace(F, log_n - 2)
        L = AffineSubspace(F, log_n, shift=1 << 62)
        poly = F.random((H.order,), rng, dev)

        def step(H=H, L=L):
            coeffs = ifft_any(poly, H)
            pad = F.zeros((L.order - H.order,), dev)
            return fft_any(torch.cat([coeffs, pad], dim=-1), L)

        _emit(args, "sumcheck_additive_encode", L.order, _timeit(step, dev))


# -- vector ops (benchmark_vector_op.cpp:12-42) ------------------------------

def suite_vector(args):
    from ..algebra.subspace import subset_sums_ints
    from ..fields.binary import gf64
    F = gf64()
    rng = np.random.default_rng(7)
    dev = args.dev
    for log_n in range(args.log_min, min(args.log_max, 20) + 1):
        basis = F.random_ints(log_n, rng)
        t0 = time.perf_counter()
        out = subset_sums_ints(F, basis, 0)
        assert len(out) == 1 << log_n
        _emit(args, "all_gf64_subset_sums", 1 << log_n,
              time.perf_counter() - t0)
        _emit(args, "random_gf64_vector", 1 << log_n,
              _once(lambda: F.random((1 << log_n,), rng, dev), dev))


# -- polynomials (benchmark_polynomials.cpp:14-104) --------------------------

def suite_poly(args):
    from ..algebra.domains import MultiplicativeCoset
    from ..algebra.linearized import LinearizedVanishing, divide_by_linearized
    from ..algebra.poly import divide_by_vanishing, mul_by_vanishing
    from ..algebra.subspace import AffineSubspace
    from ..fields.binary import gf64
    from ..fields.prime import edwards_fr
    rng = np.random.default_rng(7)
    dev = args.dev
    G = gf64()
    for log_n in range(args.log_min, min(args.log_max, 20) + 1):
        n = 1 << log_n
        t0 = time.perf_counter()
        Z = LinearizedVanishing(AffineSubspace(G, log_n))
        _emit(args, "vanishing_polynomial_from_subspace", n,
              time.perf_counter() - t0)
        # a polynomial of degree < 2^log_n over the subspace's Z (K18)
        small = G.random((n,), rng, dev)
        _emit(args, "gf64_polynomial_over_vanishing_polynomial", n,
              _timeit(lambda: divide_by_linearized(G, small, Z), dev))
    F = edwards_fr()
    for log_n in range(args.log_min, min(args.log_max, 20) + 1):
        H = MultiplicativeCoset(F, max(log_n - 2, 1))
        coeffs = F.random((1 << log_n,), rng, dev)
        _emit(args, "edwards_linearized_polynomial_times_small_polynomial",
              1 << log_n, _timeit(lambda: mul_by_vanishing(coeffs, H), dev))
        _emit(args, "edwards_polynomial_over_vanishing_polynomial",
              1 << log_n,
              _timeit(lambda: divide_by_vanishing(coeffs, H), dev))


SUITES = {"field": suite_field, "fft": suite_fft, "lagrange": suite_lagrange,
          "hashes": suite_hashes, "sumcheck": suite_sumcheck,
          "vector": suite_vector, "poly": suite_poly}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--suite", default="all",
                    choices=["all"] + sorted(SUITES))
    ap.add_argument("--fields", nargs="+",
                    default=["edwards", "gf64"],
                    choices=["edwards", "alt_bn128", "gf64", "gf128",
                             "gf192", "gf256"])
    ap.add_argument("--log_min", type=int, default=10)
    ap.add_argument("--log_max", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the card; raises without one) or cpu (the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    args.dev = resolve_device(args.device)
    for name in (sorted(SUITES) if args.suite == "all" else [args.suite]):
        SUITES[name](args)


if __name__ == "__main__":
    main()
