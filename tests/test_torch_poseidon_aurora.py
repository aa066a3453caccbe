"""The port's third slice against the reference: Aurora over alt_bn128_Fr
with Poseidon Merkle trees and the Poseidon hashchain.  The configuration
is the JAX package's own Poseidon Aurora test (tests/test_poseidon.py:91-112:
16 constraints, security 32, RS extra dimensions 2, FRI localization 1, 3
queries, one repetition, one LDT instance; example from default_rng(77),
prover rng default_rng(78)) for both hash variants, non-zk, and for
``poseidon`` with zk, where ``secrets.token_bytes`` is patched to draw from
default_rng(7) as tests/test_torch_zk_aurora.py does.  PINS are the sha256s
of the JAX prover's proof bytes in these cases, which the slow test
recomputes (and runs the JAX verifier on the port's proofs).  Tier-1 runs
only the port, one test per case (each proves once)."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import alt_bn128_fr
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: case -> (hash_name, make_zk, sha256 of the JAX package's proof bytes)
PINS = {
    "poseidon": ("poseidon", False,
                 "302af824056aa90b2df01250d8a5d60e3d3aafa42f28ca8ea28e8424c6608337"),
    "poseidon_high_alpha": (
        "poseidon_high_alpha", False,
        "3d00d3f11c6139d39ce3f03054b9114c01d439b1c7ed6197c96e87a4e9803fb2"),
    "poseidon_zk": ("poseidon", True,
                    "50ebc919c82250acc2c1d3183d0bcdc48d4eae4b02410956d9e42011816c12ae"),
}


def _config(hash_name, make_zk):
    return dict(security_parameter=32, RS_extra_dimensions=2,
                fri_localization_parameter=1, make_zk=make_zk,
                hash_name=hash_name, override_fri_queries=3,
                override_fri_interactive_repetitions=1,
                override_ldt_instances=1)


def seeded_salts(monkeypatch):
    """Every secrets.token_bytes call draws from default_rng(7) instead."""
    monkeypatch.setattr(secrets, "token_bytes",
                        np.random.default_rng(7).bytes)


def _verify(cs, primary, blob, params):
    return aurora_snark_verifier(cs, primary, BCSTranscript.deserialize(blob),
                                 params, device="cpu")


@pytest.mark.parametrize("case", sorted(PINS))
def test_port_reproduces_pin_and_verifier_accepts_and_rejects(case,
                                                              monkeypatch):
    hash_name, make_zk, pin = PINS[case]
    F = alt_bn128_fr()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                             np.random.default_rng(77))
    params = AuroraSnarkParams(**_config(hash_name, make_zk))
    seeded_salts(monkeypatch)
    blob = aurora_snark_prover(cs, primary, aux, params,
                               rng=np.random.default_rng(78),
                               device="cpu").serialize()
    assert hashlib.sha256(blob).hexdigest() == pin
    assert _verify(cs, primary, blob, params)
    bad = bytearray(blob)
    bad[32] ^= 1  # first byte of the first Merkle root
    assert not _verify(cs, primary, bytes(bad), params)
    wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
    assert not _verify(cs, wrong, blob, params)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(PINS))
def test_reference_gives_pins_and_accepts_port_proofs(case, monkeypatch):
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
    from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
    from libiop_tpu.snark.aurora import aurora_snark_verifier as jax_verifier
    hash_name, make_zk, pin = PINS[case]
    Fj = jax_alt_bn128_fr()
    cs_j, primary, aux = jax_generate(Fj, 16, 3, 15,
                                      np.random.default_rng(77))
    seeded_salts(monkeypatch)
    want = jax_prover(cs_j, primary, aux, JaxParams(**_config(
        hash_name, make_zk)), rng=np.random.default_rng(78)).serialize()
    assert hashlib.sha256(want).hexdigest() == pin
    F = alt_bn128_fr()
    cs, _, aux_t = generate_r1cs_example(F, 16, 3, 15,
                                         np.random.default_rng(77))
    params = AuroraSnarkParams(**_config(hash_name, make_zk))
    seeded_salts(monkeypatch)
    blob = aurora_snark_prover(cs, primary, aux_t, params,
                               rng=np.random.default_rng(78),
                               device="cpu").serialize()
    assert blob == want
    assert jax_verifier(cs_j, primary, JaxTranscript.deserialize(blob),
                        JaxParams(**_config(hash_name, make_zk)))
