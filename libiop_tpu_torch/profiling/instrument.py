"""Instrumentation CLI: sweep SNARK sizes, print timing and argument size
(port of libiop_tpu/profiling/instrument.py).

Counterpart of libiop/profiling/instrument_{aurora,fractal,ligero}_snark.cpp
and boost_profile.cpp's flags (--log_n_min/max --security_level --make_zk
--hash_enum --optimize_localization; instrument_aurora_snark.cpp:29-60).

Usage:
  python -m libiop_tpu_torch.profiling.instrument --snark aurora \\
      --log_n_min 6 --log_n_max 8 --security_level 64 --make_zk 0
  python -m libiop_tpu_torch.profiling.instrument --device cpu --snark fri \\
      --log_n_min 6 --log_n_max 6 --detailed

Each size prints one JSON line with ``prover_s``, ``verifier_s``,
``argument_bytes`` and ``accepted`` (and ``indexer_s`` for Fractal).  On
the card each time is host seconds that end in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device


def _timed(fn, dev):
    """(fn(), host seconds of fn ending in a device synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _example(F, log_n):
    from ..relations.examples import generate_r1cs_example
    n = 1 << log_n
    return generate_r1cs_example(F, n, (1 << 4) - 1, n - 1,
                                 np.random.default_rng(0))


def run_aurora(log_n, args, F, dev):
    from ..snark.aurora import (AuroraSnarkParams, aurora_snark_prover,
                                aurora_snark_verifier)
    cs, primary, aux = _example(F, log_n)
    n = 1 << log_n
    loc_vector = None
    if args.optimize_localization:
        p0 = AuroraSnarkParams(
            security_parameter=args.security_level,
            RS_extra_dimensions=args.rs_extra_dimensions,
            make_zk=bool(args.make_zk)).iop_params(F, n, n - 1)
        if args.optimize_localization == 2:  # recursive-circuit cost mode
            from ..protocols.fri_optimizer import \
                optimize_localization_for_circuit_size
            loc_vector, predicted = optimize_localization_for_circuit_size(
                [9], p0.codeword_domain_dim,
                p0.fri_params.num_query_repetitions,
                p0.ldt_reducer_params.max_tested_degree_bound)
            print(json.dumps({"optimized_localization": loc_vector,
                              "predicted_circuit_constraints": predicted}),
                  flush=True)
        else:
            from ..protocols.fri_optimizer import \
                optimize_localization_parameters
            loc_vector, predicted = optimize_localization_parameters(
                F, args.security_level,
                p0.ldt_reducer_params.max_tested_degree_bound,
                p0.codeword_domain_dim, args.rs_extra_dimensions,
                p0.ldt_reducer_params.absolute_proximity_parameter,
                num_input_oracles=9)
            print(json.dumps({"optimized_localization": loc_vector,
                              "predicted_fri_bytes": round(predicted)}),
                  flush=True)
    params = AuroraSnarkParams(
        security_parameter=args.security_level,
        RS_extra_dimensions=args.rs_extra_dimensions,
        fri_localization_parameter=args.localization_parameter,
        make_zk=bool(args.make_zk), hash_name=args.hash_enum,
        pow_bits=args.pow_bits, fri_localization_vector=loc_vector)
    proof, t_prove = _timed(lambda: aurora_snark_prover(
        cs, primary, aux, params, device=dev), dev)
    blob = proof.serialize()
    ok, t_verify = _timed(lambda: aurora_snark_verifier(
        cs, primary, proof, params, device=dev), dev)
    if args.detailed:
        proof.print_detailed_report()
    return dict(prover_s=t_prove, verifier_s=t_verify,
                argument_bytes=len(blob), accepted=ok)


def run_fractal(log_n, args, F, dev):
    from ..snark.fractal import (FractalSnarkParams, fractal_snark_indexer,
                                 fractal_snark_prover, fractal_snark_verifier)
    cs, primary, aux = _example(F, log_n)
    params = FractalSnarkParams(
        security_parameter=args.security_level,
        RS_extra_dimensions=args.rs_extra_dimensions,
        fri_localization_parameter=args.localization_parameter,
        make_zk=bool(args.make_zk), hash_name=args.hash_enum,
        pow_bits=args.pow_bits)
    (pidx, vidx), t_index = _timed(
        lambda: fractal_snark_indexer(cs, params, device=dev), dev)
    proof, t_prove = _timed(lambda: fractal_snark_prover(
        cs, primary, aux, pidx, params, device=dev), dev)
    blob = proof.serialize()
    ok, t_verify = _timed(lambda: fractal_snark_verifier(
        cs, primary, vidx, proof, params, device=dev), dev)
    return dict(indexer_s=t_index, prover_s=t_prove, verifier_s=t_verify,
                argument_bytes=len(blob), accepted=ok)


def run_ligero(log_n, args, F, dev):
    from ..snark.ligero import (LigeroSnarkParams, ligero_snark_prover,
                                ligero_snark_verifier)
    cs, primary, aux = _example(F, log_n)
    params = LigeroSnarkParams(
        security_parameter=args.security_level,
        RS_extra_dimensions=args.rs_extra_dimensions,
        height_width_ratio=args.height_width_ratio,
        make_zk=bool(args.make_zk), hash_name=args.hash_enum,
        pow_bits=args.pow_bits)
    proof, t_prove = _timed(lambda: ligero_snark_prover(
        cs, primary, aux, params, device=dev), dev)
    blob = proof.serialize()
    ok, t_verify = _timed(lambda: ligero_snark_verifier(
        cs, primary, proof, params, device=dev), dev)
    if args.detailed:
        proof.print_detailed_report()
    return dict(prover_s=t_prove, verifier_s=t_verify,
                argument_bytes=len(blob), accepted=ok)


def run_fri(log_n, args, F, dev):
    """FRI-isolation sweep (instrument_fri_snark.cpp:29-60,74-137 role):
    log_n is the tested polynomial's degree dimension; the RS rate and the
    localization schedule follow the reference defaults."""
    from ..snark.fri import (FRISnarkParams, fri_snark_prover,
                             fri_snark_verifier)
    rs_extra = 2  # instrument_fri_snark.cpp:85 fixes rho = 2^-2
    codeword_dim = log_n + rs_extra
    loc_vector = None
    if args.num_localization_steps:
        # [1, vals, vals, ...]: instrument_fri_snark.cpp:90-96
        remaining = codeword_dim - rs_extra - 1
        vals = remaining // args.num_localization_steps
        loc_vector = [1] + [vals] * args.num_localization_steps
    params = FRISnarkParams(
        security_parameter=args.security_level,
        codeword_domain_dim=codeword_dim,
        RS_extra_dimensions=rs_extra,
        localization_parameter=args.localization_parameter,
        localization_vector=loc_vector,
        num_oracles=args.num_oracles,
        hash_name=args.hash_enum, pow_bits=args.pow_bits,
        override_fri_queries=args.num_query_repetitions,
        override_fri_interactive_repetitions=args.num_interactive_repetitions)
    proof, t_prove = _timed(lambda: fri_snark_prover(
        F, params, np.random.default_rng(0), device=dev), dev)
    blob = proof.serialize()
    ok, t_verify = _timed(lambda: fri_snark_verifier(
        F, proof, params, device=dev), dev)
    if args.detailed:
        proof.print_detailed_report()
    return dict(prover_s=t_prove, verifier_s=t_verify,
                argument_bytes=len(blob), accepted=ok)


RUNNERS = {"aurora": run_aurora, "fractal": run_fractal,
           "ligero": run_ligero, "fri": run_fri}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snark", choices=sorted(RUNNERS), default="aurora")
    ap.add_argument("--log_n_min", type=int, default=6)
    ap.add_argument("--log_n_max", type=int, default=8)
    ap.add_argument("--security_level", type=int, default=64)
    ap.add_argument("--field_size", type=int, default=181,
                    choices=[64, 128, 181, 192, 254, 256],
                    help="181/254 = edwards_Fr/alt_bn128_Fr (multiplicative); "
                         "64/128/192/256 = GF(2^k) (additive subspaces)")
    ap.add_argument("--is_multiplicative", type=int, default=None,
                    help="1=prime-field cosets, 0=binary-field subspaces "
                         "(inferred from --field_size when omitted)")
    ap.add_argument("--make_zk", type=int, default=0)
    ap.add_argument("--hash_enum", default="blake2b",
                    choices=["blake2b", "poseidon", "poseidon_high_alpha"])
    ap.add_argument("--rs_extra_dimensions", type=int, default=3)
    ap.add_argument("--localization_parameter", type=int, default=2)
    ap.add_argument("--height_width_ratio", type=float, default=1.0)
    ap.add_argument("--pow_bits", type=int, default=0)
    ap.add_argument("--num_localization_steps", type=int, default=0,
                    help="fri only: build schedule [1, v, v, ...] "
                         "(instrument_fri_snark.cpp:90-96)")
    ap.add_argument("--num_oracles", type=int, default=1,
                    help="fri only: codewords sharing the multi-FRI")
    ap.add_argument("--num_interactive_repetitions", type=int, default=1,
                    help="fri only")
    ap.add_argument("--num_query_repetitions", type=int, default=10,
                    help="fri only (reference default, "
                         "instrument_fri_snark.cpp:149)")
    ap.add_argument("--optimize_localization", type=int, default=0,
                    help="search FRI localization vectors (aurora only): "
                         "1=argument size, 2=recursive-circuit size")
    ap.add_argument("--detailed", action="store_true",
                    help="print the per-round transcript cost breakdown")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the card; raises without one) or cpu (the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..fields import binary
    from ..fields.prime import alt_bn128_fr, edwards_fr
    fields = {181: edwards_fr, 254: alt_bn128_fr, 64: binary.gf64,
              128: binary.gf128, 192: binary.gf192, 256: binary.gf256}
    F = fields[args.field_size]()
    if args.is_multiplicative is not None:
        want = "multiplicative" if args.is_multiplicative else "additive"
        assert F.kind == want, (
            f"--field_size {args.field_size} is a {F.kind} field")
    runner = RUNNERS[args.snark]
    for log_n in range(args.log_n_min, args.log_n_max + 1):
        result = runner(log_n, args, F, dev)
        print(json.dumps({"snark": args.snark, "log_n": log_n,
                          "field": F.name, "device": str(dev), **result}),
              flush=True)


if __name__ == "__main__":
    main()
