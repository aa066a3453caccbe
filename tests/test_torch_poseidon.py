"""Port vs reference: Poseidon over alt_bn128_Fr (the reference's presets)
and edwards_Fr (stream-derived parameters).

The port's parameters equal the JAX package's; its host-int permutation,
sponge and hashchain reproduce the reference's known-answer vectors
(tests/test_poseidon.py, from libiop's test_poseidon.cpp); and K9's plain
twin, which the CPU runs, hashes 64 leaves of every leaf width on the
alt_bn128 Aurora path (and tree nodes) to the JAX package's host-int
hash_elements / two_to_one values.  Tolerance 0.  Only host ints are
compared on the JAX side: nothing is compiled."""
import numpy as np
import pytest
import torch

from libiop_tpu.bcs import poseidon as jposeidon
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.bcs import poseidon_presets as presets
from libiop_tpu_torch.bcs.merkle import MerkleTree, validate_multi_proof
from libiop_tpu_torch.bcs.poseidon import (AlgebraicSponge, BatchedPoseidon,
                                           PoseidonHashchain, PoseidonHashing,
                                           PoseidonParams, salt_to_field_elem,
                                           salts_to_elements)
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.kernels.poseidon import poseidon_merkle_heap
from torch_one_thread import one_torch_thread  # noqa: F401

_PERM_EXPECTED = 11513774210489128719203754000419293109474869123660673521809718785157314013443
_HIGH_ALPHA_EXPECTED = 19745903574422741006139475519330790957027605504238596103618584028691101830733
_SALT_ELEM_EXPECTED = 29515630589904128245248592656078826240104804215908883401742459362001266426948

FIELDS = {"alt_bn128_Fr": (alt_bn128_fr, jax_alt_bn128_fr),
          "edwards_Fr": (edwards_fr, jax_edwards_fr)}
VARIANTS = ["poseidon", "poseidon_high_alpha"]


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_params_match_reference(field, variant):
    Ft, Fj = (f() for f in FIELDS[field])
    pt = PoseidonParams.for_field(Ft, variant)
    pj = jposeidon.PoseidonParams.for_field(Fj, variant)
    for attr in ("state_size", "rate", "alpha", "full_rounds",
                 "partial_rounds", "near_mds", "round_constants", "mds"):
        assert getattr(pt, attr) == getattr(pj, attr), attr
    states = [Ft.random_ints(pt.state_size, np.random.default_rng(s))
              for s in range(3)]
    want = [pj.permute(state) for state in states]
    assert [pt.permute(state) for state in states] == want
    batched = BatchedPoseidon(pt).permute(
        Ft.from_ints(np.array(states, dtype=object).T, "cpu"))
    assert [[int(v) for v in lane] for lane in Ft.to_ints(batched).T] == want


def test_reference_permutation_and_high_alpha_vectors():
    """PermutationTest (test_poseidon.cpp:45-67): the paper instance and the
    high-alpha preset squeezed on the empty state, reset reproducing."""
    F = alt_bn128_fr()
    sp = AlgebraicSponge(PoseidonParams.from_preset(
        F, presets.PAPER_TEST_INSTANCE))
    assert sp.squeeze(1)[0] == _PERM_EXPECTED
    sp.reset()
    assert sp.squeeze(1)[0] == _PERM_EXPECTED
    pp = PoseidonParams.for_field(F, "poseidon_high_alpha")
    assert (pp.alpha, pp.full_rounds, pp.partial_rounds) == (17, 8, 29)
    assert AlgebraicSponge(pp).squeeze(1)[0] == _HIGH_ALPHA_EXPECTED


def test_reference_leafhash_and_two_to_one_vectors():
    """LeafTest and TwoToOneTest (test_poseidon.cpp:69-119)."""
    F = alt_bn128_fr()
    pp = PoseidonParams.from_preset(F, presets.PAPER_TEST_INSTANCE)

    def leafhash(vals):
        sp = AlgebraicSponge(pp)
        sp.absorb(vals)
        return sp.squeeze(1)[0]

    assert leafhash([0]) == leafhash([0]) == _PERM_EXPECTED
    assert leafhash([0, salt_to_field_elem(b"\x00" * 32, F.p)]) \
        == _PERM_EXPECTED
    salt = b"AAAAAAAABBBBBBBBCCCCCCCCDDDDDDDD"
    assert salt_to_field_elem(salt, F.p) == _SALT_ELEM_EXPECTED % F.p
    hasher = PoseidonHashing(F, 128, "poseidon")
    zero = b"\x00" * F.elem_bytes
    assert hasher.two_to_one(zero, zero) == hasher.leaf_hash(zero + zero)


def test_sponge_multi_chunk_absorb_matches_reference_recursion():
    F = alt_bn128_fr()
    pp = PoseidonParams.from_preset(F, presets.PAPER_TEST_INSTANCE)
    vals = [11, 22, 33, 44, 55]
    sp = AlgebraicSponge(pp)
    sp.absorb(vals)
    state = pp.permute([vals[0], vals[1], 0])
    state = pp.permute([state[0] + vals[2], state[1] + vals[3], state[2]])
    state = pp.permute([(state[0] + vals[4]) % F.p, state[1], state[2]])
    assert sp.squeeze(2) == state[:2]


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_hashchain_matches_reference(field):
    Ft, Fj = (f() for f in FIELDS[field])
    chains = [PoseidonHashchain(Ft), jposeidon.PoseidonHashchain(Fj)]
    out = []
    for h in chains:
        h.absorb_root(b"\x01" * Ft.elem_bytes)
        h.absorb_field_elements([7, 8])
        h.absorb_bytes(b"pow" + (5).to_bytes(8, "little"))
        out.append((h.squeeze_field_elements(3),
                    h.squeeze_query_positions(4, 64), h.state))
    assert out[0] == out[1]


# leaf widths of the alt_bn128 Aurora path, at bench.py's configuration and
# the golden one: 2 (tree nodes, FRI leaves at coset 2), 4 (FRI leaves at
# coset 4), 8 (round 0: 4 oracles at coset 2) and 13 (zk round 0: 6 oracles
# at coset 2 and the salt)
_WIDTHS = [("alt_bn128_Fr", variant, k)
           for variant in ("poseidon", "poseidon_high_alpha")
           for k in (2, 4, 8, 13)] + [("edwards_Fr", "poseidon", 8),
                                      ("edwards_Fr", "poseidon_high_alpha", 2)]


@pytest.mark.parametrize("field,variant,k", _WIDTHS)
def test_batched_twin_matches_reference_host_hash(field, variant, k):
    """64 leaves of k elements (the first all p - 1) through the port's
    batched sponge (K9's twin) against the JAX package's host
    hash_elements; at k = 2 also its two_to_one."""
    Ft, Fj = (f() for f in FIELDS[field])
    rng = np.random.default_rng(k)
    leaves = [Ft.random_ints(k, rng) for _ in range(64)]
    leaves[0] = [Ft.p - 1] * k
    cols = Ft.from_ints(np.array(leaves, dtype=object).T, "cpu")
    bp = BatchedPoseidon(PoseidonParams.for_field(Ft, variant))
    got = [int(v) for v in Ft.to_ints(bp.hash_columns(cols))]
    jh = jposeidon.PoseidonHashing(Fj, 128, variant)
    assert got == [jh.hash_elements(leaf) for leaf in leaves]
    if k == 2:
        eb = Ft.elem_bytes
        assert [v.to_bytes(eb, "little") for v in got] == [
            jh.two_to_one(a.to_bytes(eb, "little"), b.to_bytes(eb, "little"))
            for a, b in leaves]
        assert Ft.to_ints(bp.two_to_one_columns(cols[:, 0], cols[:, 1])
                          ).tolist() == got


def test_merkle_heap_and_multi_proofs_match_host():
    """A 16-leaf salted tree built by the twin (leaf elements plus a salt
    element): every node equals the reference's host hashes of the leaf
    bytes + salt, and a pruned multi-proof validates on the host."""
    F = alt_bn128_fr()
    hasher = PoseidonHashing(F, 128, "poseidon_high_alpha")
    jh = jposeidon.PoseidonHashing(jax_alt_bn128_fr(), 128,
                                   "poseidon_high_alpha")
    rng = np.random.default_rng(3)
    cols = F.from_ints(np.array([F.random_ints(16, rng) for _ in range(2)],
                                dtype=object), "cpu")               # (L, 2, 16)
    salts = rng.bytes(16 * F.elem_bytes)
    elems = torch.cat([cols, salts_to_elements(F, salts, 16, "cpu")], dim=1)
    heap = poseidon_merkle_heap(hasher.batched, elems)
    eb = F.elem_bytes
    blocks = [b"".join(int(v).to_bytes(eb, "little")
                       for v in F.to_ints(cols[:, :, j])) for j in range(16)]
    nodes = [None] * 16 + [jh.leaf_hash(b + salts[j * eb:(j + 1) * eb])
                           for j, b in enumerate(blocks)]
    for i in range(15, 0, -1):
        nodes[i] = jh.two_to_one(nodes[2 * i], nodes[2 * i + 1])
    assert hasher.heap_digests(heap, range(1, 32)) == nodes[1:]
    mt = MerkleTree(hasher, 16, heap, nodes[1], salts)
    positions = [3, 9, 10]
    leaf = [blocks[p] for p in positions]
    aux = mt.multi_proof(positions)
    assert validate_multi_proof(hasher, nodes[1], 16, positions, leaf, aux,
                                mt.reveal_salts(positions))
    assert not validate_multi_proof(hasher, nodes[1], 16, positions,
                                    [leaf[1]] + leaf[1:], aux,
                                    mt.reveal_salts(positions))


def test_leaf_hash_batch_and_tree_layer_match_host():
    """The bytes interface batched through K9 (its twin here): 64 leaf
    blocks of 40 bytes, zero-padded to two elements as the reference pads
    them, and a 64-digest tree layer, against the host hashes."""
    F = alt_bn128_fr()
    hasher = PoseidonHashing(F, 128, "poseidon")
    rng = np.random.default_rng(9)
    blocks = [rng.bytes(40) for _ in range(64)]
    digests = hasher.leaf_hash_batch(blocks, device="cpu")
    assert digests == [hasher.leaf_hash(b) for b in blocks]
    assert hasher.tree_layer(digests, device="cpu") == [
        hasher.two_to_one(digests[2 * i], digests[2 * i + 1])
        for i in range(32)]
