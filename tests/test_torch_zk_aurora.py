"""The port's zk Aurora against the reference.  A zk proof is fixed by two
inputs: the prover's numpy rng (the masking and blinding polynomials) and
``secrets.token_bytes`` (the Merkle salts).  Patching the stdlib's
``secrets.token_bytes`` with a seeded stream therefore gives both packages
the same bytes.  The golden zk configuration is the non-zk golden one
(tests/test_torch_aurora.py) with make_zk=True; GOLDEN_ZK_SHA256 is the
digest the JAX package's prover gives under that patch, which the slow test
recomputes.  Tier-1 runs only the port."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

GOLDEN_ZK_SHA256 = \
    "02e9bb70ba8ffbde03f75e379618274cdd4565c4256bb52ea9d1bd3b70e70f55"

_CONFIG = dict(security_parameter=32, RS_extra_dimensions=2,
               fri_localization_parameter=1, make_zk=True, pow_bits=0,
               override_fri_queries=3, override_fri_interactive_repetitions=1,
               override_ldt_instances=1)


def _golden_zk_setup():
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(424242))
    return F, cs, primary, aux, AuroraSnarkParams(**_CONFIG)


def seeded_salts(monkeypatch):
    """Every secrets.token_bytes call draws from default_rng(7) instead."""
    monkeypatch.setattr(secrets, "token_bytes",
                        np.random.default_rng(7).bytes)


@pytest.fixture(scope="module")
def golden_zk():
    F, cs, primary, aux, params = _golden_zk_setup()
    with pytest.MonkeyPatch.context() as mp:
        seeded_salts(mp)
        blob = aurora_snark_prover(cs, primary, aux, params,
                                   rng=np.random.default_rng(0),
                                   device="cpu").serialize()
    return F, cs, primary, params, blob


def _verify(cs, primary, t, params):
    return aurora_snark_verifier(cs, primary, t, params, device="cpu")


def test_port_zk_proof_reproduces_golden_sha256(golden_zk):
    assert hashlib.sha256(golden_zk[-1]).hexdigest() == GOLDEN_ZK_SHA256


def test_port_verifier_accepts_golden_zk_proof(golden_zk):
    F, cs, primary, params, blob = golden_zk
    assert _verify(cs, primary, BCSTranscript.deserialize(blob), params)


@pytest.mark.parametrize("tamper", ["flip_salt_byte", "drop_salts"])
def test_port_verifier_rejects_tampered_salts(golden_zk, tamper):
    F, cs, primary, params, blob = golden_zk
    t = BCSTranscript.deserialize(blob)
    salted = [prf for prf in t.mt_proofs.values() if prf.salts]
    assert salted, "the zk proof reveals no salts"
    if tamper == "flip_salt_byte":
        s = bytearray(salted[0].salts[0])
        s[0] ^= 1
        salted[0].salts[0] = bytes(s)
    else:
        salted[0].salts = None
    assert not _verify(cs, primary, BCSTranscript.deserialize(t.serialize()),
                       params)


def test_port_verifier_rejects_zk_proof_for_wrong_primary_input(golden_zk):
    F, cs, primary, params, blob = golden_zk
    wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
    assert not _verify(cs, wrong, BCSTranscript.deserialize(blob), params)


def test_real_salts_give_different_proofs_that_both_verify():
    F, cs, primary, aux, params = _golden_zk_setup()
    blobs = [aurora_snark_prover(cs, primary, aux, params,
                                 rng=np.random.default_rng(0),
                                 device="cpu").serialize() for _ in range(2)]
    assert blobs[0] != blobs[1]
    for blob in blobs:
        assert _verify(cs, primary, BCSTranscript.deserialize(blob), params)


@pytest.mark.slow
def test_reference_gives_golden_zk_sha256_and_accepts_port_proof(
        golden_zk, monkeypatch):
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
    from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
    from libiop_tpu.snark.aurora import aurora_snark_verifier as jax_verifier
    Fj = jax_edwards_fr()
    cs_j, primary, aux = jax_generate(Fj, 16, 3, 15,
                                      np.random.default_rng(424242))
    params = JaxParams(**_CONFIG)
    seeded_salts(monkeypatch)
    want = jax_prover(cs_j, primary, aux, params,
                      rng=np.random.default_rng(0)).serialize()
    assert hashlib.sha256(want).hexdigest() == GOLDEN_ZK_SHA256
    assert jax_verifier(cs_j, primary, JaxTranscript.deserialize(golden_zk[-1]),
                        params)
