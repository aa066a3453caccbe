"""The public functions the port took over from the JAX package last,
against the JAX package's: the device vanishing polynomial at a point batch
(pinned), the host-int helpers (vanishing coefficients, host power tables,
Horner), the unshifted subgroup, IOPProtocol.get_oracle_domain,
SparseMatrix.num_nonzero, MerkleTree.from_leaf_digests and
materialize_nodes (BLAKE2b and Poseidon), the host BLAKE2b batch
(Blake2bHashing and native_blake2b), the BlockProfiler's explicit blocks
and report, the fields' to_int, is_zero and select (pinned), and
MatrixIndexer.compute_oracles (through the Fractal index roots' pin).
Host functions are compared live; each JAX function that compiles is held
to a pin here and recomputed by a slow test.  Tolerance 0."""
import hashlib
import re

import numpy as np
import pytest
import torch

from libiop_tpu.algebra import domains as ref_domains
from libiop_tpu.algebra import generic as ref_generic
from libiop_tpu.algebra import poly as ref_poly
from libiop_tpu.bcs import hashing as ref_hashing
from libiop_tpu.bcs import merkle as ref_merkle
from libiop_tpu.bcs import native_blake2b as ref_native
from libiop_tpu.bcs import poseidon as ref_poseidon
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu.iop import runtime as ref_runtime
from libiop_tpu.relations.examples import \
    generate_r1cs_example as ref_generate
from libiop_tpu.utils import profiling as ref_profiling
from libiop_tpu_torch.algebra import domains, generic, poly
from libiop_tpu_torch.bcs import hashing, native_blake2b
from libiop_tpu_torch.bcs.merkle import MerkleTree
from libiop_tpu_torch.bcs.poseidon import PoseidonHashing
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_to_numpy
from libiop_tpu_torch.iop import runtime
from libiop_tpu_torch.protocols import fractal_indexer
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.fractal import fractal_snark_indexer
from libiop_tpu_torch.utils import profiling
from test_torch_fractal import PINS as FRACTAL_PINS
from test_torch_fractal import _example, _params, roots_digest
from torch_one_thread import one_torch_thread  # noqa: F401

F, RF = edwards_fr(), ref_prime.edwards_fr()
G, RG = binary.gf64(), ref_binary.gf64()

#: sha256 of the JAX package's vanishing_eval_at_point and
#: vanishing_formal_derivative_at_point limbs at _points() on the coset of
#: dimension 4 and shift 19 (tests/test_algebra.py:13-47's domains)
VANISHING_PINS = (
    "e284a3ee4c4c36b986ecc61bf19728a0835be100e9858c51ebdf3a3f89f252ce",
    "d54fe84e49bc7531c269ea09fa4b2a1299730c89e3b2a630ccfe3dc406ac9fc8")


def _digest(arr) -> str:
    return hashlib.sha256(np.asarray(arr).astype("<u4").tobytes()).hexdigest()


def _points():
    """A (L, 2, 3) batch: five points drawn from a seed and one element of
    the coset (where Z_H is 0)."""
    ints = F.random_ints(5, np.random.default_rng(21))
    ints.append(domains.MultiplicativeCoset(F, 4, shift=19)
                .element_by_index_int(6))
    return np.array(ints, dtype=object).reshape(2, 3)


def test_vanishing_at_point_matches_reference():
    H = domains.MultiplicativeCoset(F, 4, shift=19)
    pts = _points()
    x = F.from_ints(pts, "cpu")
    z = poly.vanishing_eval_at_point(H, x)
    dz = poly.vanishing_formal_derivative_at_point(H, x)
    assert z.shape == dz.shape == x.shape
    assert (_digest(limbs_to_numpy(z)), _digest(limbs_to_numpy(dz))) == \
        VANISHING_PINS
    p, h = F.p, H.order
    flat = [int(v) for v in pts.reshape(-1)]
    assert [int(v) for v in F.to_ints(z).reshape(-1)] == \
        [(pow(v, h, p) - pow(19, h, p)) % p for v in flat]
    assert [int(v) for v in F.to_ints(dz).reshape(-1)] == \
        [h * pow(v, h - 1, p) % p for v in flat]


def test_host_polynomial_helpers_match_reference():
    """vanishing_coeffs_ints, host_powers, host_powers_any, horner_eval_ints
    and unshifted_subgroup, live."""
    for dim, shift in ((3, 1), (5, 19)):
        H = domains.MultiplicativeCoset(F, dim, shift=shift)
        RH = ref_domains.MultiplicativeCoset(RF, dim, shift=shift)
        assert poly.vanishing_coeffs_ints(H) == \
            ref_poly.vanishing_coeffs_ints(RH)
        U, RU = H.unshifted_subgroup(), RH.unshifted_subgroup()
        assert (U.dim, U.shift, U.g) == (RU.dim, RU.shift, RU.g) == \
            (dim, 1, H.g)
    rng = np.random.default_rng(22)
    for Fx, RFx in ((F, RF), (G, RG), (alt_bn128_fr(),
                                       ref_prime.alt_bn128_fr())):
        x, start = Fx.random_ints(2, rng)
        want = ref_generic.host_powers_any(RFx, x, 9, start=start)
        np.testing.assert_array_equal(
            generic.host_powers_any(Fx, x, 9, start=start), want)
        coeffs = Fx.random_ints(7, rng)
        assert generic.horner_eval_ints(Fx, coeffs, x) == \
            ref_generic.horner_eval_ints(RFx, coeffs, x)
    x = F.random_ints(1, rng)[0]
    np.testing.assert_array_equal(domains.host_powers(F, x, 17, start=5),
                                  ref_domains.host_powers(RF, x, 17, start=5))


def test_get_oracle_domain_matches_reference():
    def build(rt, Fx, D):
        iop = rt.IOPProtocol(Fx, *(("cpu",) if rt is runtime else ()))
        d0 = iop.register_domain(D(Fx, 3))
        d1 = iop.register_domain(D(Fx, 4, shift=Fx.multiplicative_generator))
        o0 = iop.register_oracle(d1, 8)
        o1 = iop.register_oracle(d0, 4)
        return [iop.get_oracle_domain(o)._key() for o in (o0, o1)]

    assert build(runtime, F, domains.MultiplicativeCoset) == \
        build(ref_runtime, RF, ref_domains.MultiplicativeCoset)


def test_num_nonzero_matches_reference():
    ct = generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(23))[0]
    cj = ref_generate(RF, 16, 3, 15, np.random.default_rng(23))[0]
    got = [M.num_nonzero for M in ct.matrices()]
    assert got == [M.num_nonzero for M in cj.matrices()]
    assert all(n > 0 for n in got)


@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_merkle_from_leaf_digests_matches_reference(kind):
    """A tree over precomputed leaf digests has the JAX package's root and
    node list (materialize_nodes), multi-proofs and revealed salts."""
    rng = np.random.default_rng(24)
    if kind == "blake2b":
        hasher, ref_hasher = (hashing.Blake2bHashing(128),
                              ref_hashing.Blake2bHashing(128))
        digests = [rng.bytes(hasher.digest_bytes) for _ in range(8)]
    else:
        Fb = alt_bn128_fr()
        hasher = PoseidonHashing(Fb)
        ref_hasher = ref_poseidon.PoseidonHashing(ref_prime.alt_bn128_fr())
        digests = [v.to_bytes(Fb.elem_bytes, "little")
                   for v in Fb.random_ints(8, rng)]
    salts = [rng.bytes(hasher.salt_bytes) for _ in range(8)]
    ref = ref_merkle.MerkleTree.from_leaf_digests(ref_hasher, digests, salts)
    mt = MerkleTree.from_leaf_digests(hasher, digests, salts, device="cpu")
    assert mt.root == ref.root
    assert mt.materialize_nodes() == ref.materialize_nodes()
    assert mt.multi_proof([1, 6, 6]) == ref.multi_proof([1, 6, 6])
    assert mt.reveal_salts([6, 1]) == [salts[1], salts[6]]


def test_host_blake2b_batch_matches_reference():
    """Blake2bHashing's batch hashes and native_blake2b's bindings give the
    JAX package's digests (and hashlib's)."""
    rng = np.random.default_rng(25)
    hasher, ref_hasher = (hashing.Blake2bHashing(128),
                          ref_hashing.Blake2bHashing(128))
    arr = np.frombuffer(rng.bytes(6 * 40), np.uint8).reshape(6, 40)
    blocks = [bytes(r) for r in arr]
    mixed = blocks[:3] + [b"short"]
    digests = [rng.bytes(32) for _ in range(8)]
    assert hasher.leaf_hash_batch_array(arr) == \
        ref_hasher.leaf_hash_batch_array(arr) == \
        [hasher.leaf_hash(b) for b in blocks]
    for bs in (blocks, mixed):
        assert hasher.leaf_hash_batch(bs) == ref_hasher.leaf_hash_batch(bs)
    assert hasher.tree_layer(digests) == ref_hasher.tree_layer(digests) == \
        [hasher.two_to_one(digests[i], digests[i + 1])
         for i in range(0, 8, 2)]
    assert native_blake2b.available() and ref_native.available()
    for tag in (None, b"\x00"):
        assert native_blake2b.hash_batch(blocks, 24, tag) == \
            ref_native.hash_batch(blocks, 24, tag)
        assert native_blake2b.hash_batch_array(arr, 16, tag) == \
            ref_native.hash_batch_array(arr, 16, tag)
        assert native_blake2b.tree_layer(digests, 32, tag) == \
            ref_native.tree_layer(digests, 32, tag)
    assert native_blake2b.hash_batch(mixed, 32) is None
    assert native_blake2b.hash_batch_array(arr[:0], 32) is None


def test_block_profiler_explicit_blocks_match_reference(capsys):
    """enter_block/leave_block record the JAX package's (depth, name) tree
    and print_report prints it in the same format."""
    def run(mod):
        prof = mod.BlockProfiler()
        prof.enter_block("outer")
        with prof.block("inner"):
            pass
        prof.enter_block("second")
        prof.leave_block("second")
        prof.leave_block("outer")
        with pytest.raises(AssertionError):
            prof.enter_block("a")
            prof.leave_block("b")
        prof.print_report()
        lines = capsys.readouterr().out.splitlines()
        return ([(d, n) for d, n, _ in prof.records],
                [re.sub(r"\[ *[0-9.]+s\]", "[t]", ln) for ln in lines])

    port, ref = run(profiling), run(ref_profiling)
    assert port == ref
    assert port[0] == [(1, "inner"), (1, "second"), (0, "outer")]


def _field_inputs(Fx):
    vals = Fx.random_ints(3, np.random.default_rng(26)) + [0]
    return vals, [False, True, True, False]


def _field_surface(Fx, vals, pred, from_ints, to_np):
    """to_int of the first element, is_zero, and select(pred, a, b)."""
    a = from_ints(vals)
    b = from_ints(vals[::-1])
    return [Fx.to_int(a), [bool(v) for v in to_np(Fx.is_zero(a))],
            _digest(to_np(Fx.select(pred, a, b)))]


_ZERO_LAST = [False, False, False, True]
#: field name -> the JAX package's [to_int, is_zero, sha256 of select] on
#: _field_inputs()
FIELD_PINS = {
    "edwards_Fr": [
        840086704678291912742667922481019443963251838050354490, _ZERO_LAST,
        "836ecaaf741a65a13f04240529f6ec4adbf73dd3fd159a159c4f454f9790ed89"],
    "alt_bn128_Fr": [
        4414264945940507242091024226710608147184464216183078113734280640028708446696,  # noqa: E501
        _ZERO_LAST,
        "c20e674d8ef3d7768376fefd177b7d9b3874c7bab4f21efe3463183845815edd"],
    "gf64": [
        9068399419970302404, _ZERO_LAST,
        "6d29403991e2cb6c4e6879c1a461bf8c1056bd3c91d52de13a3df4232039c992"],
    "gf192": [
        424380776274653597391631012109436515203346019054961832388, _ZERO_LAST,
        "783e7ad6308749908190585897dbc63dcc57f043e6dbe11e5398ce0ad2c8ee8d"]}


@pytest.mark.parametrize("name", sorted(FIELD_PINS))
def test_field_predicates_match_reference_pins(name):
    Fx = {"edwards_Fr": edwards_fr, "alt_bn128_Fr": alt_bn128_fr,
          "gf64": binary.gf64, "gf192": binary.gf192}[name]()
    vals, pred = _field_inputs(Fx)
    got = _field_surface(Fx, vals, torch.tensor(pred),
                         lambda v: Fx.from_ints(v, "cpu"),
                         lambda t: limbs_to_numpy(t) if t.ndim > 1
                         else t.numpy())
    assert got[0] == vals[0]
    assert got == FIELD_PINS[name]


def test_compute_oracles_gives_the_fractal_index_pin(monkeypatch):
    """The Fractal indexer submits each matrix's index oracles through
    MatrixIndexer.compute_oracles; the index roots are the JAX package's
    (tests/test_torch_fractal.py's pin)."""
    calls = []
    real = fractal_indexer.MatrixIndexer.compute_oracles

    def spy(self, device="cuda"):
        calls.append(device)
        return real(self, device)
    monkeypatch.setattr(fractal_indexer.MatrixIndexer, "compute_oracles", spy)
    cs, _, _ = _example(F)
    _, vidx = fractal_snark_indexer(cs, _params(False),
                                    rng=np.random.default_rng(2),
                                    device="cpu")
    assert len(calls) == 3
    assert roots_digest(vidx) == FRACTAL_PINS[False][0]


@pytest.mark.slow
def test_reference_device_functions_give_the_pins():
    """The JAX package's vanishing polynomial at a point batch and its
    fields' to_int, is_zero and select hash to the pins."""
    RH = ref_domains.MultiplicativeCoset(RF, 4, shift=19)
    x = RF.from_ints(_points())
    assert (_digest(ref_poly.vanishing_eval_at_point(RH, x)),
            _digest(ref_poly.vanishing_formal_derivative_at_point(RH, x))) \
        == VANISHING_PINS
    import jax.numpy as jnp
    for name, RFx in (("edwards_Fr", RF), ("alt_bn128_Fr",
                                           ref_prime.alt_bn128_fr()),
                      ("gf64", RG), ("gf192", ref_binary.gf192())):
        vals, pred = _field_inputs(RFx)
        got = _field_surface(RFx, vals, jnp.asarray(pred), RFx.from_ints,
                             np.asarray)
        assert got == FIELD_PINS[name], name
