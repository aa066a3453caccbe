"""The port's Ligero SNARK over a binary field and over alt_bn128_Fr against
the reference, in the configuration of tests/test_additive_aurora.py:114-137
(16 constraints, 3 inputs, 15 variables, example from default_rng(41),
security 32, RS extra 2, height/width 1.0, prover rng default_rng(42)):
GF(2^64) with BLAKE2b, and alt_bn128_Fr with BLAKE2b and with Poseidon.
Tier 1 holds the port's proofs to sha256 pins of the JAX package's
(tolerance 0) and to the verifier's verdicts; the slow test reruns the JAX
prover and holds each package's verifier to the other's proofs.  Also the
explicit-target lincheck over an affine subspace (tests/test_ligero_et.py,
kind "additive")."""
import hashlib

import numpy as np
import pytest

from libiop_tpu_torch.algebra.generic import fft_any, ifft_any
from libiop_tpu_torch.algebra.subspace import AffineSubspace
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.binary import gf64
from libiop_tpu_torch.fields.prime import alt_bn128_fr
from libiop_tpu_torch.iop.runtime import IOPProtocol
from libiop_tpu_torch.protocols.ligero import InterleavedLincheckET
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations.sparse import SparseMatrix
from libiop_tpu_torch.snark.ligero import (LigeroSnarkParams,
                                           ligero_snark_prover,
                                           ligero_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

#: case -> (field, hash_name, sha256 of the JAX package's proof)
PINS = {
    "gf64": ("gf64", "blake2b",
             "f430a1dfffed9ba5d208c40fe3eb431572a43c92363955e22e706ee0cc6ae5ce"),
    "bn128_blake2b": (
        "alt_bn128", "blake2b",
        "487792ef0780af2380ce49ef93c92584fe8a7929f60246bf0a384857e22a029a"),
    "bn128_poseidon": (
        "alt_bn128", "poseidon",
        "a8b0f4f1b58a739b3af2202ced8907fa25919f3bd1b219b15609010a31d6da86")}

FIELDS = {"gf64": gf64, "alt_bn128": alt_bn128_fr}


def _params(hash_name):
    return LigeroSnarkParams(security_parameter=32, RS_extra_dimensions=2,
                             height_width_ratio=1.0, hash_name=hash_name)


def _example(F):
    return generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(41))


def _wrong(F, primary):
    return [F.add_ints(primary[0], 1)] + list(primary[1:])


@pytest.mark.parametrize("case", sorted(PINS))
def test_port_ligero_reproduces_reference_pin_and_verifies(case):
    """The port's proof hashes to the JAX package's pin (a binary field
    raises nothing), verifies, and a flipped byte of the first Merkle root
    or a wrong primary input is rejected."""
    field, hash_name, want = PINS[case]
    F = FIELDS[field]()
    cs, primary, aux = _example(F)
    params = _params(hash_name)
    blob = ligero_snark_prover(cs, primary, aux, params,
                               rng=np.random.default_rng(42),
                               device="cpu").serialize()
    assert hashlib.sha256(blob).hexdigest() == want
    bad = bytearray(blob)
    bad[32] ^= 1
    verdicts = [ligero_snark_verifier(cs, prim, BCSTranscript.deserialize(b),
                                      params, device="cpu")
                for prim, b in ((primary, blob), (primary, bytes(bad)),
                                (_wrong(F, primary), blob))]
    assert verdicts == [True, False, False]


def _run_et_additive(make_zk, tamper_target, tamper_witness, rng):
    """The reference's _run (tests/test_ligero_et.py) over gf64 subspaces."""
    F = gf64()
    H = AffineSubspace(F, dim=3)
    ext = AffineSubspace(F, dim=4)
    L = AffineSubspace(F, dim=5, shift=1 << 62)
    num_oracles, h = 2, H.order
    width, height = num_oracles * h, h
    x = [int(rng.integers(1, 1 << 48)) % F.field_size for _ in range(width)]
    entries = [(i, int(c), int(rng.integers(1, 1 << 30)) % F.field_size)
               for i in range(height)
               for c in rng.choice(width, size=3, replace=False)]
    M = SparseMatrix.from_entries(F, height, width, entries)
    b = [0] * height
    for (i, j, v) in entries:
        b[i] = F.add_ints(b[i], F.mul_ints(v, x[j]))
    if tamper_target:
        b[0] = F.add_ints(b[0], 1)
    iop = IOPProtocol(F, "cpu", seed=11)
    l_h, h_h, e_h = (iop.register_domain(D) for D in (L, H, ext))
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
        iop.submit_oracle(rh, fft_any(ifft_any(
            F.from_ints(x[i * h:(i + 1) * h], "cpu"), H), L))
    for bh in blind_handles:
        vals = [int(rng.integers(0, 1 << 48)) % F.field_size
                for _ in range(h - 1)]
        last = 0
        for v in vals:
            last = F.sub_ints(last, v)
        iop.submit_oracle(bh, fft_any(ifft_any(
            F.from_ints(vals + [last], "cpu"), H), L))
    iop.signal_prover_round_done()
    et.calculate_and_submit_responses()
    iop.signal_prover_round_done()
    return et.verifier_predicate()


def test_et_lincheck_over_subspaces_accepts_and_rejects():
    """gf64: accepts, accepts with zk blinding rows, rejects a wrong target
    and a wrong witness (each from default_rng(12345))."""
    runs = [(False, False, False), (True, False, False),
            (False, True, False), (False, False, True)]
    assert [_run_et_additive(*r, np.random.default_rng(12345))
            for r in runs] == [True, True, False, False]


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(PINS))
def test_reference_gives_pins_and_cross_verifies(case):
    """The JAX prover gives the pinned digest; each package's verifier
    accepts the other's proof."""
    from libiop_tpu.bcs.common import BCSTranscript as JaxTranscript
    from libiop_tpu.fields.binary import gf64 as jax_gf64
    from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
    from libiop_tpu.relations.examples import \
        generate_r1cs_example as jax_example
    from libiop_tpu.snark import ligero as jax_ligero
    field, hash_name, want = PINS[case]
    Fj = {"gf64": jax_gf64, "alt_bn128": jax_alt_bn128_fr}[field]()
    cs_j, primary, aux = jax_example(Fj, 16, 3, 15,
                                     np.random.default_rng(41))
    params_j = jax_ligero.LigeroSnarkParams(**vars(_params(hash_name)))
    blob_j = jax_ligero.ligero_snark_prover(
        cs_j, primary, aux, params_j,
        rng=np.random.default_rng(42)).serialize()
    assert hashlib.sha256(blob_j).hexdigest() == want
    F = FIELDS[field]()
    cs, _, _ = _example(F)
    blob = ligero_snark_prover(cs, primary, aux, _params(hash_name),
                               rng=np.random.default_rng(42),
                               device="cpu").serialize()
    assert jax_ligero.ligero_snark_verifier(
        cs_j, primary, JaxTranscript.deserialize(blob), params_j)
    assert ligero_snark_verifier(cs, primary,
                                 BCSTranscript.deserialize(blob_j),
                                 _params(hash_name), device="cpu")
