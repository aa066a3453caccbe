"""The port's whole slice against the reference: the Aurora proof of the
golden configuration (tests/test_golden_transcript.py) serializes to bytes
whose sha256 is the JAX package's pinned GOLDEN_SHA256, the port's verifier
accepts it and rejects a flipped byte and a wrong primary input.  The JAX
prover is not run here (its CPU compile costs minutes); the pinned digest
is what the JAX package's own test holds it to."""
import hashlib

import numpy as np
import pytest
import torch

from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from test_golden_transcript import GOLDEN_SHA256
from torch_one_thread import one_torch_thread  # noqa: F401


def _golden_setup():
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(424242))
    params = AuroraSnarkParams(
        security_parameter=32, RS_extra_dimensions=2,
        fri_localization_parameter=1, make_zk=False, pow_bits=0,
        override_fri_queries=3, override_fri_interactive_repetitions=1,
        override_ldt_instances=1)
    return F, cs, primary, aux, params


@pytest.fixture(scope="module")
def golden_proof():
    F, cs, primary, aux, params = _golden_setup()
    blob = aurora_snark_prover(cs, primary, aux, params,
                               rng=np.random.default_rng(0),
                               device="cpu").serialize()
    return F, cs, primary, params, blob


def test_port_reproduces_golden_sha256(golden_proof):
    blob = golden_proof[-1]
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


def test_port_verifier_accepts_golden_proof(golden_proof):
    F, cs, primary, params, blob = golden_proof
    assert aurora_snark_verifier(cs, primary, BCSTranscript.deserialize(blob),
                                 params, device="cpu")


def test_port_verifier_rejects_flipped_byte(golden_proof):
    F, cs, primary, params, blob = golden_proof
    bad = bytearray(blob)
    bad[32] ^= 1  # first byte of the first Merkle root
    assert not aurora_snark_verifier(
        cs, primary, BCSTranscript.deserialize(bytes(bad)), params,
        device="cpu")


def test_port_verifier_rejects_wrong_primary_input(golden_proof):
    F, cs, primary, params, blob = golden_proof
    wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
    assert not aurora_snark_verifier(cs, wrong, BCSTranscript.deserialize(blob),
                                     params, device="cpu")


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    F, cs, primary, aux, params = _golden_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aurora_snark_prover(cs, primary, aux, params)
