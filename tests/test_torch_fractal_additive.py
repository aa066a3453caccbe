"""The port's Fractal over a binary field against the reference: the index
roots and the proof bytes of the three-phase SNARK over GF(2^64) in the
configuration of tests/test_additive_aurora.py:139-157 (example from
default_rng(51), security 32, RS extra 2, FRI localization 1, 3 queries,
1 repetition, 1 LDT instance, prover rng default_rng(52)), non-zk and zk
(the same parameters with make_zk=True and the Merkle salts from
default_rng(7)), tolerance 0.

Tier 1 runs the port only, against sha256 pins of the JAX package's
outputs (computed in a process of its own: the JAX Fractal prover over
gf64 takes minutes on a CPU): the roots, the proofs, the verifier's
verdicts, and an index reused for a second proof with no round-0 hashing.
The slow test reruns the JAX indexer and prover, holds each verifier to
the other package's proof, and proves in the port from an index the JAX
package made."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.bcs import prover as port_bcs_prover
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.binary import gf64
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.fractal import (FractalSnarkParams,
                                            fractal_snark_indexer,
                                            fractal_snark_prover,
                                            fractal_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: make_zk -> (sha256 of the index roots in key order, sha256 of the
#: proof), as the JAX package gives them
PINS = {
    False: ("d120168b33d1fa2f502aa62ea4c4f091785e4f62b4149acc4239de94dba6adcd",
            "6feb5d34322564ed68a04d3d06ea1a91d8c9faa0136d48ee7c891363e7c798c6"),
    True: ("0d55b85be312e7cf0ad387c653aaea14b5417778e89265579fb17e6b46fa3342",
           "ebc3f504721aef88054290185c73447274510f02318069883fcb6bafe8b057f5")}


def roots_digest(verifier_index) -> str:
    return hashlib.sha256(b"".join(
        root for _, root in sorted(verifier_index.items()))).hexdigest()


def _params(make_zk):
    return FractalSnarkParams(
        security_parameter=32, RS_extra_dimensions=2,
        fri_localization_parameter=1, make_zk=make_zk,
        override_fri_queries=3, override_fri_interactive_repetitions=1,
        override_ldt_instances=1)


def _example(F):
    return generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(51))


def _prove(cs, primary, aux, prover_index, make_zk, mp):
    mp.setattr(secrets, "token_bytes", np.random.default_rng(7).bytes)
    return fractal_snark_prover(cs, primary, aux, prover_index,
                                _params(make_zk),
                                rng=np.random.default_rng(52),
                                device="cpu").serialize()


def _verify(make_zk, primary, vidx, blob):
    cs, _, _ = _example(gf64())
    return fractal_snark_verifier(cs, primary, vidx,
                                  BCSTranscript.deserialize(blob),
                                  _params(make_zk), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """make_zk -> (prover index, verifier index, proof bytes), the port's,
    on the CPU."""
    cs, primary, aux = _example(gf64())
    out = {}
    for make_zk in (False, True):
        pidx, vidx = fractal_snark_indexer(cs, _params(make_zk), device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            out[make_zk] = (pidx, vidx,
                            _prove(cs, primary, aux, pidx, make_zk, mp))
    return out


def test_port_additive_fractal_reproduces_reference_pins_and_verifies(runs):
    """Non-zk and zk: the index roots and the proof hash to the JAX
    package's pins; the proof verifies; a flipped byte of the first
    round-1 root and a wrong primary input are rejected."""
    _, primary, _ = _example(gf64())
    wrong = [primary[0] ^ 1] + list(primary[1:])
    for make_zk, (_, vidx, blob) in runs.items():
        assert (roots_digest(vidx), hashlib.sha256(blob).hexdigest()) == \
            PINS[make_zk], make_zk
        # the second root (round 1): 4 + 4 + 8 + 4 header bytes, then per
        # root its (round, domain) and length words and its bytes
        bad = bytearray(blob)
        bad[20 + 12 + len(next(iter(vidx.values()))) + 12] ^= 1
        verdicts = [_verify(make_zk, prim, vidx, b)
                    for prim, b in ((primary, blob), (primary, bytes(bad)),
                                    (wrong, blob))]
        assert verdicts == [True, False, False], make_zk


def test_port_additive_proves_twice_from_one_index_without_hashing_round0(
        runs, monkeypatch):
    """A second proof from the fixture's index rehydrates every round-0
    tree from its nodes, hashes none of the index oracles, and gives the
    fixture's bytes (non-zk: the prover draws no randomness)."""
    cs, primary, aux = _example(gf64())
    pidx, _, blob = runs[False]
    rehydrated, hashed = [], []
    real_from_nodes = port_bcs_prover.MerkleTree.from_nodes.__func__
    hasher_cls = type(_params(False).bcs_params().make_hasher(gf64()))
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
                                 rng=np.random.default_rng(52),
                                 device="cpu").serialize()
    index_evals = list(pidx[0].values())
    assert rehydrated == [len(pidx[2][k][0]) for k in sorted(pidx[2])]
    assert hashed and not any(h is e for h in hashed for e in index_evals)
    assert again == blob


# -- slow: the JAX package live ---------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("make_zk", [False, True])
def test_reference_gives_additive_pins_and_cross_verifies(runs, make_zk,
                                                          monkeypatch):
    """The JAX indexer and prover give the pinned digests; each verifier
    accepts the other package's proof; the port proves from the JAX
    package's index (through fractal_index_from_reference) the same bytes."""
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.binary import gf64 as jax_gf64
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_example
    from libiop_tpu.snark import fractal as jax_fractal
    from libiop_tpu_torch.interop import fractal_index_from_reference
    cs_j, primary, aux = jax_example(jax_gf64(), 16, 3, 15,
                                     np.random.default_rng(51))
    params_j = jax_fractal.FractalSnarkParams(**vars(_params(make_zk)))
    pidx_j, vidx_j = jax_fractal.fractal_snark_indexer(cs_j, params_j)
    monkeypatch.setattr(secrets, "token_bytes",
                        np.random.default_rng(7).bytes)
    blob_j = jax_fractal.fractal_snark_prover(
        cs_j, primary, aux, pidx_j, params_j,
        rng=np.random.default_rng(52)).serialize()
    assert (roots_digest(vidx_j), hashlib.sha256(blob_j).hexdigest()) == \
        PINS[make_zk]
    _, vidx, blob = runs[make_zk]
    assert jax_fractal.fractal_snark_verifier(
        cs_j, primary, vidx_j, JaxTranscript.deserialize(blob), params_j)
    assert _verify(make_zk, primary, vidx, blob_j)
    cs, _, _ = _example(gf64())
    pidx_from_j = fractal_index_from_reference(gf64(), pidx_j)
    blob_from_j = _prove(cs, primary, aux, pidx_from_j, make_zk, monkeypatch)
    assert hashlib.sha256(blob_from_j).hexdigest() == PINS[make_zk][1]
    assert _verify(make_zk, primary, vidx_j, blob_from_j)
