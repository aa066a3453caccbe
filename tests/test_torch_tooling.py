"""The port's tooling against the reference: the transcript reports and
the pruned-proof digest count on the same bytes, both FRI localization
optimizers on the same inputs (host math, compared live), the golden
Aurora configuration proved with the optimizer's localization vector
(pinned to the JAX package's proof), the instrument CLI's FRI sweep on the
CPU (its argument size pinned to the JAX CLI's) and every microbench suite
at a tiny size."""
import hashlib
import json

import numpy as np

from libiop_tpu.bcs.common import BCSTranscript as RefTranscript
from libiop_tpu.bcs.merkle import count_proof_hashes as ref_count
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu.protocols import fri as ref_fri
from libiop_tpu.protocols import fri_optimizer as ref_opt
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.bcs.merkle import count_proof_hashes
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import fri_parameters_from_reference
from libiop_tpu_torch.profiling import instrument, microbench
from libiop_tpu_torch.protocols import fri_optimizer as opt
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from libiop_tpu_torch.snark.fri import FRISnarkParams, fri_snark_prover
from torch_one_thread import one_torch_thread  # noqa: F401

#: the golden configuration (tests/test_golden_transcript.py) proved with
#: the localization vector optimize_localization_parameters returns for it
#: (the instrument's --optimize_localization 1 inputs): the JAX package's
#: proof digest and length (the vector is [1]: one fold, then the final
#: polynomial)
AURORA_OPT_PIN = (
    "28f63558a646c24968a7dc8a1d198f9fdcbb8bd4d013229c21c6136c64163352", 1294)
#: argument_bytes of the JAX CLI's `instrument --snark fri --log_n_min 6
#: --log_n_max 6` (security 64, edwards_Fr, BLAKE2b, 10 queries)
INSTRUMENT_FRI_BYTES = 2730

_PAIRS = {"edwards_Fr": (edwards_fr, ref_prime.edwards_fr),
          "alt_bn128_Fr": (alt_bn128_fr, ref_prime.alt_bn128_fr),
          "gf192": (binary.gf192, ref_binary.gf192)}


def test_detailed_report_and_proof_hash_count_match_reference(capsys):
    """On the same proof bytes (a port FRI SNARK proof, four rounds of
    trees) both packages' reports and printed tables are equal, and each
    tree's auxiliary digests are count_proof_hashes of its positions."""
    F = edwards_fr()
    params = FRISnarkParams(security_parameter=32, codeword_domain_dim=8,
                            RS_extra_dimensions=2, localization_parameter=1,
                            num_oracles=2, override_fri_queries=4,
                            override_fri_interactive_repetitions=1)
    blob = fri_snark_prover(F, params, rng=np.random.default_rng(3),
                            device="cpu").serialize()
    port, ref = BCSTranscript.deserialize(blob), RefTranscript.deserialize(blob)
    assert port.argument_size_bytes() == ref.argument_size_bytes() == len(blob)
    assert port.detailed_report() == ref.detailed_report()
    port.print_detailed_report()
    printed = capsys.readouterr().out
    ref.print_detailed_report()
    assert printed == capsys.readouterr().out
    assert len(port.mt_proofs) == 5
    for (rnd, _), prf in port.mt_proofs.items():
        num_leaves = (1 << (8 - rnd)) // 2  # localization 1: cosets of 2
        assert count_proof_hashes(num_leaves, prf.positions) == \
            ref_count(num_leaves, prf.positions) == len(prf.aux_digests)
    rng = np.random.default_rng(11)
    for depth in (1, 4, 9):
        n = 1 << depth
        for q in (1, 3, 17):
            pos = [int(v) for v in rng.integers(0, n, q)]
            assert count_proof_hashes(n, pos) == ref_count(n, pos)


def test_argument_size_optimizer_matches_reference():
    """optimize_localization_parameters, predict_argument_size and
    expected_pruned_path_digests give the JAX package's values exactly."""
    cases = [("edwards_Fr", 64, 1 << 10, 13, 3, 9),
             ("edwards_Fr", 128, 1 << 16, 18, 2, 9),
             ("alt_bn128_Fr", 32, 1 << 6, 8, 2, 4),
             ("gf192", 128, 1 << 14, 16, 2, 9)]
    for name, sec, degree, dim, extra, oracles in cases:
        make, make_ref = _PAIRS[name]
        F, RF = make(), make_ref()
        got = opt.optimize_localization_parameters(
            F, sec, degree, dim, extra, (1 << dim) // 4, oracles)
        want = ref_opt.optimize_localization_parameters(
            RF, sec, degree, dim, extra, (1 << dim) // 4, oracles)
        assert got == want, name
        ref_params = ref_fri.FRIParameters(
            RF, sec + 3, sec + 1, "heuristic", degree, dim, extra,
            (1 << dim) // 4, want[0])
        assert opt.predict_argument_size(
            F, fri_parameters_from_reference(F, ref_params), oracles, 32) \
            == ref_opt.predict_argument_size(RF, ref_params, oracles, 32)
    for depth in (0, 3, 12, 20):
        for q in (1, 10, 300):
            assert opt.expected_pruned_path_digests(depth, q) == \
                ref_opt.expected_pruned_path_digests(depth, q)


def test_circuit_size_optimizer_matches_reference():
    """optimize_localization_for_circuit_size and predict_circuit_size give
    the JAX package's vectors and constraint counts exactly."""
    cases = [([9], 13, 30, 1 << 10, 100, (300, 150, 300)),
             ([9, 3], 18, 64, 1 << 16, 50, (300, 150, 300)),
             ([1], 10, 10, 1 << 8, 100, (200, 100, 250))]
    for loc, dim, q, degree, per_query, costs in cases:
        got = opt.optimize_localization_for_circuit_size(
            loc, dim, q, degree, per_query, opt.HashCircuitDescription(*costs))
        want = ref_opt.optimize_localization_for_circuit_size(
            loc, dim, q, degree, per_query,
            ref_opt.HashCircuitDescription(*costs))
        assert got == want
        assert opt.predict_circuit_size(
            loc, [1, 2, 2], dim, q, degree, per_query,
            opt.HashCircuitDescription(*costs)) == ref_opt.predict_circuit_size(
            loc, [1, 2, 2], dim, q, degree, per_query,
            ref_opt.HashCircuitDescription(*costs))


def test_golden_aurora_with_optimized_localization_reproduces_pin():
    """The argument-size optimizer's vector for the golden configuration
    equals the JAX package's, and the port's proof with it has the JAX
    package's bytes and verifies."""
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(424242))
    kw = dict(security_parameter=32, RS_extra_dimensions=2,
              fri_localization_parameter=1, make_zk=False, pow_bits=0,
              override_fri_queries=3, override_fri_interactive_repetitions=1,
              override_ldt_instances=1)
    p0 = AuroraSnarkParams(**kw).iop_params(F, cs.num_constraints,
                                            cs.num_variables)
    args = (32, p0.ldt_reducer_params.max_tested_degree_bound,
            p0.codeword_domain_dim, 2,
            p0.ldt_reducer_params.absolute_proximity_parameter)
    vec, predicted = opt.optimize_localization_parameters(
        F, *args, num_input_oracles=9)
    assert (vec, predicted) == ref_opt.optimize_localization_parameters(
        ref_prime.edwards_fr(), *args, num_input_oracles=9)
    params = AuroraSnarkParams(fri_localization_vector=vec, **kw)
    blob = aurora_snark_prover(cs, primary, aux, params,
                               rng=np.random.default_rng(0),
                               device="cpu").serialize()
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == AURORA_OPT_PIN
    assert aurora_snark_verifier(cs, primary, BCSTranscript.deserialize(blob),
                                 params, device="cpu")


def test_instrument_fri_sweep_on_cpu(capsys):
    """`instrument --device cpu --snark fri` prints the report and a JSON
    line with the JAX CLI's argument size, accepted."""
    instrument.main(["--device", "cpu", "--snark", "fri", "--log_n_min", "6",
                     "--log_n_max", "6", "--detailed"])
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert line["snark"] == "fri" and line["device"] == "cpu"
    assert line["accepted"] is True
    assert line["argument_bytes"] == INSTRUMENT_FRI_BYTES
    assert line["prover_s"] > 0 and line["verifier_s"] > 0
    assert any(s.startswith("IOP bytes:") for s in out)


def test_microbench_suites_print_their_lines(capsys, monkeypatch):
    """Every suite prints one JSON line per case at a tiny size (each case
    timed once after its warm call: the lines, not the times, are under
    test here)."""
    timeit = microbench._timeit
    monkeypatch.setattr(microbench, "_timeit",
                        lambda fn, dev, runs=5: timeit(fn, dev, runs=1))
    expect = {"field": "edwards_mul_vec", "fft": "multiplicative_coset_FFT",
              "lagrange": "bivariate_lagrange_multiplicative",
              "hashes": "poseidon_leaf_1elem",
              "sumcheck": "sumcheck_additive_encode",
              "vector": "all_gf64_subset_sums",
              "poly": "edwards_polynomial_over_vanishing_polynomial"}
    for suite, bench in expect.items():
        log = 8 if suite == "sumcheck" else 2
        microbench.main(["--device", "cpu", "--suite", suite, "--log_min",
                         str(log), "--log_max", str(log)])
        lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
        assert bench in {ln["bench"] for ln in lines}, suite
        for ln in lines:
            assert ln["device"] == "cpu" and ln["seconds"] > 0, ln
