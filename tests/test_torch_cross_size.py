"""Both provers at a second size give identical proof bytes: 64 constraints,
FRI localization 2, 4 pow bits, 32-bit security.  Marked slow: the JAX
prover alone costs minutes of XLA compile on the CPU."""
import numpy as np
import pytest

from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.relations.examples import generate_r1cs_example as jax_generate
from libiop_tpu.snark.aurora import AuroraSnarkParams as JaxParams
from libiop_tpu.snark.aurora import aurora_snark_prover as jax_prover
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.interop import r1cs_from_reference
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

_CONFIG = dict(security_parameter=32, RS_extra_dimensions=2,
               fri_localization_parameter=2, make_zk=False, pow_bits=4)


@pytest.mark.slow
def test_port_and_reference_proofs_are_byte_identical_at_64_constraints():
    Fj = jax_edwards_fr()
    cs_j, primary, aux = jax_generate(Fj, 64, 3, 63, np.random.default_rng(64))
    want = jax_prover(cs_j, primary, aux, JaxParams(**_CONFIG),
                      rng=np.random.default_rng(0)).serialize()
    cs_t = r1cs_from_reference(edwards_fr(), 3, 63, cs_j.constraints)
    params = AuroraSnarkParams(**_CONFIG)
    got = aurora_snark_prover(cs_t, primary, aux, params, device="cpu")
    assert got.serialize() == want
    assert aurora_snark_verifier(cs_t, primary, BCSTranscript.deserialize(want),
                                 params, device="cpu")
