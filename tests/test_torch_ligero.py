"""The port's Ligero against the reference: the interactive IOP and the
explicit-target lincheck (mirroring tests/test_ligero.py and
tests/test_ligero_et.py, multiplicative domains), and the SNARK's proof
bytes in the configuration of tests/test_snark_wrappers.py:16, non-zk and
zk.  A zk proof is fixed by the prover's numpy rng (the blinding rows and
the LDT's masking polynomial) and ``secrets.token_bytes`` (the Merkle
salts), which both packages call; patched with a seeded stream, both give
the same bytes.  The PINS are the JAX package's digests, which the slow
test recomputes; it also holds each package's verifier to the other's
proofs."""
import hashlib
import secrets

import numpy as np
import pytest

from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.algebra.generic import fft_any, ifft_any
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.iop.runtime import IOPProtocol
from libiop_tpu_torch.protocols.ligero import (InterleavedLincheckET,
                                               LigeroIOP, LigeroIOPParams)
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations.sparse import SparseMatrix
from libiop_tpu_torch.snark.ligero import (LigeroSnarkParams,
                                           ligero_snark_prover,
                                           ligero_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: sha256 of the JAX package's Ligero proofs in the configuration below
PINS = {False: "c4bf652076e40e8813bb563eb3d678b2becee3ff4c927807666a11d39b95a3fc",
        True: "4dcd9d150b81cfdd4494d54776ba96a774b7154b0fa9209cbc4a3ab9997c5aa8"}

_CONFIG = dict(security_parameter=32, RS_extra_dimensions=2, pow_bits=2,
               override_num_interactions=1, override_num_queries=4,
               override_ldt_instances=1)


def _example(F):
    return generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(12345))


def _seeded_salts(mp):
    mp.setattr(secrets, "token_bytes", np.random.default_rng(7).bytes)


@pytest.fixture(scope="module")
def proofs():
    """make_zk -> the port's proof bytes, proven on the CPU."""
    F = edwards_fr()
    cs, primary, aux = _example(F)
    out = {}
    for make_zk in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            _seeded_salts(mp)
            out[make_zk] = ligero_snark_prover(
                cs, primary, aux, LigeroSnarkParams(make_zk=make_zk, **_CONFIG),
                rng=np.random.default_rng(7), device="cpu").serialize()
    return out


def _verify(make_zk, primary, blob):
    cs, _, _ = _example(edwards_fr())
    return ligero_snark_verifier(cs, primary, BCSTranscript.deserialize(blob),
                                 LigeroSnarkParams(make_zk=make_zk, **_CONFIG),
                                 device="cpu")


def test_port_ligero_proofs_reproduce_reference_pins_and_verify(proofs):
    """Non-zk and zk: the port's proof hashes to the JAX package's pin,
    verifies, and a flipped byte or a wrong primary input is rejected."""
    F = edwards_fr()
    _, primary, _ = _example(F)
    wrong = [(primary[0] + 1) % F.p] + list(primary[1:])
    for make_zk, blob in proofs.items():
        assert hashlib.sha256(blob).hexdigest() == PINS[make_zk], make_zk
        assert _verify(make_zk, primary, blob), make_zk
        bad = bytearray(blob)
        bad[60] ^= 1
        assert not _verify(make_zk, primary, bytes(bad)), make_zk
        assert not _verify(make_zk, wrong, blob), make_zk


# -- the interactive IOP (tests/test_ligero.py) -----------------------------

def _ligero_params(F, make_zk, m=16, n=15):
    p = LigeroIOPParams(F, security_parameter=32, RS_extra_dimensions=2,
                        height_width_ratio=1.0, make_zk=make_zk,
                        num_constraints=m, num_variables=n)
    p.encoded_params.num_interactions = 1
    p.encoded_params.num_queries = 4
    p.direct_ldt_params.num_queries = 4
    p.ldt_reducer_params.num_output_LDT_instances = 1
    return p


def _run_ligero(make_zk, tamper_aux, seed, rng):
    F = edwards_fr()
    cs, primary, aux = generate_r1cs_example(F, 16, 3, 15, rng)
    if tamper_aux:
        aux = list(aux)
        aux[0] = (aux[0] + 1) % F.p
    iop = IOPProtocol(F, "cpu", seed=seed)
    lig = LigeroIOP(iop, cs, _ligero_params(F, make_zk),
                    rng=np.random.default_rng(8))
    lig.register_interactions()
    iop.seal_interaction_registrations()
    lig.register_queries()
    iop.seal_query_registrations()
    lig.produce_proof(primary, aux)
    return lig.verifier_predicate(primary)


def test_ligero_interactive_iop_accepts_and_rejects():
    """Accepts non-zk and zk, rejects a tampered auxiliary input (each run
    on the example from default_rng(12345), as the reference's tests)."""
    assert _run_ligero(False, False, 21, np.random.default_rng(12345))
    assert _run_ligero(True, False, 21, np.random.default_rng(12345))
    assert not _run_ligero(False, True, 22, np.random.default_rng(12345))


# -- the explicit-target lincheck (tests/test_ligero_et.py) -----------------

def _run_et(make_zk, tamper_target, tamper_witness, rng):
    F = edwards_fr()
    H = MultiplicativeCoset(F, dim=3)
    ext = MultiplicativeCoset(F, dim=4)
    L = MultiplicativeCoset(F, dim=5, shift=F.multiplicative_generator)
    num_oracles = 2
    h = H.order
    width = num_oracles * h
    height = h  # one block of constraints

    x = [int(rng.integers(1, 1 << 48)) % F.p for _ in range(width)]
    entries = [(i, int(c), int(rng.integers(1, 1 << 30)) % F.p)
               for i in range(height)
               for c in rng.choice(width, size=3, replace=False)]
    M = SparseMatrix.from_entries(F, height, width, entries)
    b = [0] * height  # b = M x
    for (i, j, v) in entries:
        b[i] = F.add_ints(b[i], F.mul_ints(v, x[j]))
    if tamper_target:
        b[0] = F.add_ints(b[0], 1)

    iop = IOPProtocol(F, "cpu", seed=11)
    l_h = iop.register_domain(L)
    h_h = iop.register_domain(H)
    e_h = iop.register_domain(ext)
    et = InterleavedLincheckET(iop, l_h, h_h, e_h, num_oracles,
                               num_queries=4, num_interactions=2,
                               make_zk=make_zk, matrix=M, target_vector=b)
    row_handles = [iop.register_oracle(l_h, h) for _ in range(num_oracles)]
    et.attach_input_vector_row_oracles(row_handles)
    blind_handles = []
    if make_zk:
        blind_handles = [iop.register_oracle(l_h, 2 * h) for _ in range(2)]
        et.attach_blinding_vector_row_oracles(blind_handles)
    et.register_linear_combinations()
    et.register_responses()
    iop.seal_interaction_registrations()
    et.register_queries()
    iop.seal_query_registrations()

    if tamper_witness:
        x = list(x)
        x[1] = F.add_ints(x[1], 1)
    for i, rh in enumerate(row_handles):
        block = x[i * h:(i + 1) * h]
        iop.submit_oracle(rh, fft_any(ifft_any(F.from_ints(block, "cpu"), H),
                                      L))
    for bh in blind_handles:
        # a blinding row summing to zero over H
        vals = [int(rng.integers(0, 1 << 48)) % F.p for _ in range(h - 1)]
        last = 0
        for v in vals:
            last = F.sub_ints(last, v)
        iop.submit_oracle(bh, fft_any(ifft_any(
            F.from_ints(vals + [last], "cpu"), H), L))
    iop.signal_prover_round_done()
    et.calculate_and_submit_responses()
    iop.signal_prover_round_done()
    return et.verifier_predicate()


def test_et_lincheck_accepts_and_rejects():
    """Multiplicative domains: accepts, accepts with zk blinding rows,
    rejects a wrong target and a wrong witness (each run from
    default_rng(12345), as the reference's tests)."""
    assert _run_et(False, False, False, np.random.default_rng(12345))
    assert _run_et(True, False, False, np.random.default_rng(12345))
    assert not _run_et(False, True, False, np.random.default_rng(12345))
    assert not _run_et(False, False, True, np.random.default_rng(12345))


@pytest.mark.slow
@pytest.mark.parametrize("make_zk", [False, True])
def test_reference_gives_pins_and_cross_verifies(proofs, make_zk,
                                                 monkeypatch):
    """The JAX prover gives the pinned digest; the JAX verifier accepts the
    port's proof and the port's verifier the JAX package's."""
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_generate
    from libiop_tpu.snark.ligero import LigeroSnarkParams as JaxParams
    from libiop_tpu.snark.ligero import ligero_snark_prover as jax_prover
    from libiop_tpu.snark.ligero import ligero_snark_verifier as jax_verifier
    cs_j, primary, aux = jax_generate(jax_edwards_fr(), 16, 3, 15,
                                      np.random.default_rng(12345))
    params = JaxParams(make_zk=make_zk, **_CONFIG)
    _seeded_salts(monkeypatch)
    want = jax_prover(cs_j, primary, aux, params,
                      rng=np.random.default_rng(7)).serialize()
    assert hashlib.sha256(want).hexdigest() == PINS[make_zk]
    assert jax_verifier(cs_j, primary,
                        JaxTranscript.deserialize(proofs[make_zk]), params)
    assert _verify(make_zk, primary, want)
