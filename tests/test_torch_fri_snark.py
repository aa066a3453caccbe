"""The port's FRI SNARK against the reference: the proof bytes of
tests/test_snark_wrappers.py:35-47's configuration (edwards_Fr, BLAKE2b)
and of an alt_bn128_Fr configuration with Poseidon trees and an explicit
localization vector.  The PINS are the JAX package's digests of its proofs
from the same prover rng, which the slow test recomputes; it also holds
each package's verifier to the other's proofs."""
import hashlib

import numpy as np
import pytest

from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.snark.fri import (FRISnarkParams, fri_snark_prover,
                                        fri_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: case -> (field, FRISnarkParams keywords, prover seed, sha256 and length
#: of the JAX package's proof)
CASES = {
    "edwards_blake2b": (
        "edwards", dict(security_parameter=32, codeword_domain_dim=8,
                        RS_extra_dimensions=2, localization_parameter=1,
                        num_oracles=2, pow_bits=2, override_fri_queries=4,
                        override_fri_interactive_repetitions=1), 3,
        "bbd18bb0e21d5088443eca6e58e6a58d41feb9b038fd30ddce84027464e86626",
        2973),
    "bn128_poseidon": (
        "alt_bn128", dict(security_parameter=32, codeword_domain_dim=8,
                          RS_extra_dimensions=2, localization_vector=[1, 2, 2],
                          num_oracles=2, hash_name="poseidon", pow_bits=2,
                          override_fri_queries=3,
                          override_fri_interactive_repetitions=1), 5,
        "2ddb4f67fb0be6a16d9f6fad61c928c05611c420031a535d86f6738845077047",
        3027),
}
_FIELDS = {"edwards": edwards_fr, "alt_bn128": alt_bn128_fr}


def _port_proof(case):
    field, kw, seed, _, _ = CASES[case]
    F = _FIELDS[field]()
    params = FRISnarkParams(**kw)
    proof = fri_snark_prover(F, params, rng=np.random.default_rng(seed),
                             device="cpu")
    return F, params, proof.serialize()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_fri_snark_reproduces_reference_pin_and_verifies(case):
    """The port's proof has the JAX package's bytes (sha256 pin), verifies,
    and a flipped byte of a Merkle root is rejected."""
    F, params, blob = _port_proof(case)
    assert len(blob) == CASES[case][4]
    assert hashlib.sha256(blob).hexdigest() == CASES[case][3]
    assert fri_snark_verifier(F, BCSTranscript.deserialize(blob), params,
                              device="cpu")
    bad = BCSTranscript.deserialize(blob)
    key = sorted(bad.mt_roots)[0]
    root = bytearray(bad.mt_roots[key])
    root[0] ^= 1
    bad.mt_roots[key] = bytes(root)
    assert not fri_snark_verifier(F, bad, params, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_fri_snark_gives_the_pins_and_cross_verifies(case):
    """The JAX prover's bytes are the pin and the port's; the JAX verifier
    accepts the port's proof and the port's verifier the JAX proof."""
    from libiop_tpu.bcs.common import BCSTranscript as RefTranscript
    from libiop_tpu.fields.prime import alt_bn128_fr as ref_bn128
    from libiop_tpu.fields.prime import edwards_fr as ref_edwards
    from libiop_tpu.snark import fri as ref_fri
    field, kw, seed, digest, _ = CASES[case]
    RF = {"edwards": ref_edwards, "alt_bn128": ref_bn128}[field]()
    ref_params = ref_fri.FRISnarkParams(**kw)
    ref_blob = ref_fri.fri_snark_prover(
        RF, ref_params, rng=np.random.default_rng(seed)).serialize()
    assert hashlib.sha256(ref_blob).hexdigest() == digest
    F, params, blob = _port_proof(case)
    assert blob == ref_blob
    assert ref_fri.fri_snark_verifier(RF, RefTranscript.deserialize(blob),
                                      ref_params)
    assert fri_snark_verifier(F, BCSTranscript.deserialize(ref_blob), params,
                              device="cpu")
