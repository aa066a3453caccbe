"""The port's Aurora over binary fields against the reference.

The golden configuration is the JAX package's additive one
(tests/test_additive_aurora.py:82-88: GF(2^64), 16 constraints, example
from default_rng(777), security 32, RS extra 2, FRI localization 1, 3
queries, prover rng default_rng(0)); its non-zk proof must hash to
ADDITIVE_GOLDEN_SHA256, which the JAX package's own tier-1 test pins.  The
zk pin is the same configuration with make_zk=True and
``secrets.token_bytes`` drawn from default_rng(7), as the JAX package's
prover gives it; the GF(2^128) and GF(2^256) pins are the golden
configuration with pow 4 over those fields.  Tier 1 runs only the port;
the slow tests rerun the JAX prover for the zk, gf128 and gf256 pins and
cross-verify GF(2^192) proofs both ways."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.binary import gf64, gf128, gf192, gf256
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: tests/test_additive_aurora.py:78 (the JAX package's pin)
ADDITIVE_GOLDEN_SHA256 = \
    "8a7c80d5983fb537d0c3ea970110ffe7cbdbaf7020e54ea5f4ad3701273981e9"
#: the JAX package's zk proof of the golden configuration with the salts
#: drawn from default_rng(7)
ADDITIVE_GOLDEN_ZK_SHA256 = \
    "ca0f0a1485857e5bc738f1778561db2a2c453c4c94588c26ed6c8cca5b0958dd"

#: (field, make_zk) -> (pow bits, sha256 of the JAX package's proof): the
#: golden configuration, and over GF(2^128) and GF(2^256) the same with
#: pow 4 (the JAX package's proofs, recomputed by the slow test)
PINS = {("gf64", False): (0, ADDITIVE_GOLDEN_SHA256),
        ("gf64", True): (0, ADDITIVE_GOLDEN_ZK_SHA256),
        ("gf128", False): (
            4, "3e705fdd0e8504f127271914f47ebe20819ce412622848359d5bc8391872b902"),
        ("gf256", False): (
            4, "65b29226e28456312cba57a3905ca3f09bfb22f21cf7288b0a8fc727423f315f")}


def _config(make_zk, pow_bits=0):
    return dict(security_parameter=32, RS_extra_dimensions=2,
                fri_localization_parameter=1, make_zk=make_zk,
                pow_bits=pow_bits, override_fri_queries=3,
                override_fri_interactive_repetitions=1,
                override_ldt_instances=1)


def _prove(prover, cs, primary, aux, params, **kw):
    """A proof with the prover rng default_rng(0) and the salts from
    default_rng(7)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(secrets, "token_bytes", np.random.default_rng(7).bytes)
        return prover(cs, primary, aux, params, rng=np.random.default_rng(0),
                      **kw).serialize()


@pytest.mark.parametrize("field,make_zk", [
    pytest.param("gf64", False, id="False"),
    pytest.param("gf64", True, id="True"),
    pytest.param("gf128", False, id="gf128-False"),
    pytest.param("gf256", False, id="gf256-False")])
def test_port_additive_proof_reproduces_pin(field, make_zk):
    F = {"gf64": gf64, "gf128": gf128, "gf256": gf256}[field]()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15,
                                             np.random.default_rng(777))
    assert cs.is_satisfied(primary, aux)
    pow_bits, want = PINS[field, make_zk]
    params = AuroraSnarkParams(**_config(make_zk, pow_bits))
    blob = _prove(aurora_snark_prover, cs, primary, aux, params,
                  device="cpu")
    assert hashlib.sha256(blob).hexdigest() == want
    bad = bytearray(blob)
    bad[32] ^= 1  # first byte of the first Merkle root
    wrong = [primary[0] ^ 1] + list(primary[1:])
    verdicts = [aurora_snark_verifier(cs, prim, BCSTranscript.deserialize(b),
                                      params, device="cpu")
                for prim, b in ((primary, blob), (primary, bytes(bad)),
                                (wrong, blob))]
    assert verdicts == [True, False, False]


@pytest.mark.slow
def test_reference_prover_gives_the_zk_pin():
    from libiop_tpu.fields.binary import gf64 as jax_gf64
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
    from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
    cs, primary, aux = jax_generate(jax_gf64(), 16, 3, 15,
                                    np.random.default_rng(777))
    blob = _prove(jax_prover, cs, primary, aux, JaxParams(**_config(True)))
    assert hashlib.sha256(blob).hexdigest() == ADDITIVE_GOLDEN_ZK_SHA256


@pytest.mark.slow
@pytest.mark.parametrize("field", ["gf128", "gf256"])
def test_reference_prover_gives_the_pow4_pins(field):
    from libiop_tpu.fields import binary as jax_binary
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
    from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
    cs, primary, aux = jax_generate(getattr(jax_binary, field)(), 16, 3, 15,
                                    np.random.default_rng(777))
    pow_bits, want = PINS[field, False]
    blob = _prove(jax_prover, cs, primary, aux,
                  JaxParams(**_config(False, pow_bits)))
    assert hashlib.sha256(blob).hexdigest() == want


@pytest.mark.slow
def test_gf192_proofs_cross_verify():
    """The JAX verifier accepts the port's GF(2^192) proof and the port's
    verifier the JAX package's, both ways byte-identical."""
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.binary import gf192 as jax_gf192
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
    from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
    from libiop_tpu.snark.aurora import aurora_snark_verifier as jax_verifier
    config = dict(_config(False), pow_bits=2)
    cs_j, primary, aux = jax_generate(jax_gf192(), 32, 3, 31,
                                      np.random.default_rng(22))
    cs_t, primary_t, aux_t = generate_r1cs_example(gf192(), 32, 3, 31,
                                                   np.random.default_rng(22))
    assert (primary_t, aux_t) == (primary, aux)
    assert cs_t.constraints == cs_j.constraints
    port_blob = aurora_snark_prover(cs_t, primary, aux,
                                    AuroraSnarkParams(**config),
                                    device="cpu").serialize()
    jax_blob = jax_prover(cs_j, primary, aux, JaxParams(**config)).serialize()
    assert port_blob == jax_blob
    assert jax_verifier(cs_j, primary, JaxTranscript.deserialize(port_blob),
                        JaxParams(**config))
    assert aurora_snark_verifier(cs_t, primary,
                                 BCSTranscript.deserialize(jax_blob),
                                 AuroraSnarkParams(**config), device="cpu")
