"""The port's Fractal over edwards_Fr against the reference: the index
roots and the proof bytes of the three-phase SNARK in the configuration of
tests/test_fractal.py:63-98 (example from default_rng(12345), indexer rng
default_rng(2), prover rng default_rng(3)), non-zk and zk (Merkle salts
from default_rng(7)), tolerance 0.

Tier 1 runs the port only, against sha256 pins of the JAX package's
outputs: the roots, the proofs, the verifier's verdicts, an index reused
for a second proof with no round-0 hashing, and the interactive IOP
rejecting an invalid witness.  The slow tests rerun the JAX indexer and prover,
hold the JAX verifier to the port's proofs, and prove in the port from an
index the JAX package made."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.bcs import prover as port_bcs_prover
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.iop.runtime import IOPProtocol
from libiop_tpu_torch.protocols.fractal import FractalIOP, FractalIOPParams
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.fractal import (FractalSnarkParams,
                                            fractal_snark_indexer,
                                            fractal_snark_prover,
                                            fractal_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: make_zk -> (sha256 of the index roots in key order, sha256 of the
#: proof), as the JAX package gives them
PINS = {
    False: ("5c1c47f95a92264ead18fbbad32f58b19c50fb18c470c0bb879581f224ec332a",
            "c331495442d9c6c6e2bdbb6e43238d2842fe142ac184bef9dfb20858d7eb0ba0"),
    True: ("cb5405b37a03ca61b33e69a8c4bf17e516a5453cce44a8a22c983ff76f4eaf4d",
           "397b367b9f301b48f136b0e58f9953d204706230e5eca8a8f2836622ca1595d7")}


def _params(make_zk):
    return FractalSnarkParams(
        security_parameter=32, RS_extra_dimensions=1,
        fri_localization_parameter=1, make_zk=make_zk, pow_bits=2,
        override_fri_queries=4, override_fri_interactive_repetitions=1,
        override_ldt_instances=1, override_lincheck_repetitions=1)


def _example(F):
    return generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(12345))


def roots_digest(verifier_index) -> str:
    return hashlib.sha256(b"".join(
        root for _, root in sorted(verifier_index.items()))).hexdigest()


def _prove(cs, primary, aux, prover_index, make_zk, mp, rng_seed=3):
    mp.setattr(secrets, "token_bytes", np.random.default_rng(7).bytes)
    return fractal_snark_prover(cs, primary, aux, prover_index,
                                _params(make_zk),
                                rng=np.random.default_rng(rng_seed),
                                device="cpu").serialize()


@pytest.fixture(scope="module")
def runs():
    """make_zk -> (prover index, verifier index, proof bytes), the port's,
    on the CPU."""
    F = edwards_fr()
    cs, primary, aux = _example(F)
    out = {}
    for make_zk in (False, True):
        pidx, vidx = fractal_snark_indexer(cs, _params(make_zk),
                                           rng=np.random.default_rng(2),
                                           device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            out[make_zk] = (pidx, vidx,
                            _prove(cs, primary, aux, pidx, make_zk, mp))
    return out


def _verify(make_zk, primary, vidx, blob):
    cs, _, _ = _example(edwards_fr())
    return fractal_snark_verifier(cs, primary, vidx,
                                  BCSTranscript.deserialize(blob),
                                  _params(make_zk), device="cpu")


def test_port_fractal_reproduces_reference_pins_and_verifies(runs):
    """Non-zk and zk: the index roots and the proof hash to the JAX
    package's pins; the proof verifies; a flipped index root, a flipped
    byte of a later root and a wrong primary input are rejected."""
    F = edwards_fr()
    _, primary, _ = _example(F)
    wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
    for make_zk, (_, vidx, blob) in runs.items():
        assert (roots_digest(vidx), hashlib.sha256(blob).hexdigest()) == \
            PINS[make_zk], make_zk
        assert _verify(make_zk, primary, vidx, blob), make_zk
        bad_index = dict(vidx)
        key = sorted(bad_index)[0]
        bad_index[key] = bytes([bad_index[key][0] ^ 1]) + bad_index[key][1:]
        assert not _verify(make_zk, primary, bad_index, blob), make_zk
        # the second root (round 1): 4 + 4 + 8 + 4 header bytes, then per
        # root its (round, domain) and length words and its bytes
        bad = bytearray(blob)
        bad[20 + 12 + len(vidx[key]) + 12] ^= 1
        assert not _verify(make_zk, primary, vidx, bytes(bad)), make_zk
        assert not _verify(make_zk, wrong, vidx, blob), make_zk


def test_port_proves_twice_from_one_index_without_hashing_round0(
        runs, monkeypatch):
    """The prover index is a checkpoint: a second proof from the index the
    fixture proved from rehydrates every round-0 tree from its nodes,
    hashes none of the index oracles, and gives the fixture's bytes, which
    verify (the index roots are the verifier's)."""
    F = edwards_fr()
    cs, primary, aux = _example(F)
    pidx, vidx, blob = runs[False]
    rehydrated, hashed = [], []
    real_from_nodes = port_bcs_prover.MerkleTree.from_nodes.__func__
    hasher_cls = type(_params(False).bcs_params().make_hasher(F))
    real_leaf_digests = hasher_cls.device_leaf_digests

    def counting_from_nodes(cls, hasher, num_leaves, heap):
        rehydrated.append(num_leaves)
        return real_from_nodes(cls, hasher, num_leaves, heap)

    def counting_leaf_digests(self, F, evals, *args, **kw):
        hashed.extend(evals)
        return real_leaf_digests(self, F, evals, *args, **kw)

    monkeypatch.setattr(port_bcs_prover.MerkleTree, "from_nodes",
                        classmethod(counting_from_nodes))
    monkeypatch.setattr(hasher_cls, "device_leaf_digests",
                        counting_leaf_digests)
    again = fractal_snark_prover(cs, primary, aux, pidx, _params(False),
                                 rng=np.random.default_rng(5),
                                 device="cpu").serialize()
    index_evals = list(pidx[0].values())
    assert rehydrated == [len(pidx[2][k][0]) for k in sorted(pidx[2])]
    assert hashed and not any(h is e for h in hashed for e in index_evals)
    assert again == blob  # non-zk: the prover draws no randomness
    assert _verify(False, primary, vidx, again)


def _iop_params(F, r1cs, make_zk):
    p = FractalIOPParams(F, security_parameter=32, pow_bits=0,
                         RS_extra_dimensions=1, make_zk=make_zk, r1cs=r1cs,
                         fri_localization_parameter=1)
    p.fri_params.num_query_repetitions = 12
    p.fri_params.num_interactive_repetitions = 1
    p.ldt_reducer_params.num_output_LDT_instances = 1
    p.encoded_params.holographic_lincheck_params.num_repetitions = 1
    return p


def test_fractal_iop_rejects_invalid_witness():
    """The interactive holographic IOP (tests/test_fractal.py:45-61)
    rejects a witness with a changed auxiliary value (the example's own
    witness is accepted through the pinned proofs above)."""
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(
        F, 16, 3, 15, np.random.default_rng(12345))
    aux = [(aux[0] + 1) % F.p] + list(aux[1:])
    iop = IOPProtocol(F, "cpu", seed=32)
    fr = FractalIOP(iop, cs, _iop_params(F, cs, False),
                    rng=np.random.default_rng(4))
    fr.register_interactions()
    iop.seal_interaction_registrations()
    fr.register_queries()
    iop.seal_query_registrations()
    fr.produce_index()
    fr.produce_proof(primary, aux)
    assert not fr.verifier_predicate(primary)


# -- slow: the JAX package live ---------------------------------------------

def _jax_setup():
    from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_example
    from libiop_tpu.snark import fractal as jax_fractal
    Fj = jax_edwards_fr()
    return Fj, jax_example(Fj, 16, 3, 15, np.random.default_rng(12345)), \
        jax_fractal


def _jax_params(jax_fractal, make_zk):
    return jax_fractal.FractalSnarkParams(**vars(_params(make_zk)))


@pytest.mark.slow
@pytest.mark.parametrize("make_zk", [False, True])
def test_reference_gives_pins_and_cross_verifies(runs, make_zk, monkeypatch):
    """The JAX indexer and prover give the pinned digests; the JAX
    verifier accepts the port's proof; the port proves from the JAX
    package's index (through fractal_index_from_reference) the same bytes,
    which both verifiers accept."""
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu_torch.interop import fractal_index_from_reference
    Fj, (cs_j, primary, aux), jax_fractal = _jax_setup()
    params_j = _jax_params(jax_fractal, make_zk)
    pidx_j, vidx_j = jax_fractal.fractal_snark_indexer(
        cs_j, params_j, rng=np.random.default_rng(2))
    monkeypatch.setattr(secrets, "token_bytes",
                        np.random.default_rng(7).bytes)
    blob_j = jax_fractal.fractal_snark_prover(
        cs_j, primary, aux, pidx_j, params_j,
        rng=np.random.default_rng(3)).serialize()
    assert (roots_digest(vidx_j), hashlib.sha256(blob_j).hexdigest()) == \
        PINS[make_zk]
    _, vidx, blob = runs[make_zk]
    assert jax_fractal.fractal_snark_verifier(
        cs_j, primary, vidx_j, JaxTranscript.deserialize(blob), params_j)
    cs, _, _ = _example(edwards_fr())
    pidx_from_j = fractal_index_from_reference(edwards_fr(), pidx_j)
    blob_from_j = _prove(cs, primary, aux, pidx_from_j, make_zk, monkeypatch)
    assert hashlib.sha256(blob_from_j).hexdigest() == PINS[make_zk][1]
    assert _verify(make_zk, primary, vidx_j, blob_from_j)
