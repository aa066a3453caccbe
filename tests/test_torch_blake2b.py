"""Port vs reference: tagged BLAKE2b rows (leaves and Merkle levels), the
device leaf pipeline, the Merkle heap and pruned multi-proofs.  Digests must
equal hashlib's and the JAX package's byte for byte."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libiop_tpu.algebra.generic import element_outside_of_subset as jax_outside
from libiop_tpu.algebra.generic import make_domain as jax_make_domain
from libiop_tpu.bcs import common as jcommon
from libiop_tpu.bcs.device_blake2b import (blake2b_words, merkle_heap_words,
                                           prefix_tag_words)
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.algebra.generic import (element_outside_of_subset,
                                              make_domain)
from libiop_tpu_torch.bcs import common
from libiop_tpu_torch.bcs.hashing import Blake2bHashing
from libiop_tpu_torch.bcs.merkle import MerkleTree, validate_multi_proof
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy
from libiop_tpu_torch.kernels.blake2b import (blake2b_rows, digest_rows_to_bytes,
                                              merkle_heap)
from torch_one_thread import one_torch_thread  # noqa: F401


def _rows(rng, n, msg_bytes):
    nw = max(1, -(-msg_bytes // 4))
    msgs = [bytes(rng.integers(0, 256, size=msg_bytes, dtype=np.uint8))
            for _ in range(n)]
    rows = np.stack([np.frombuffer(m + b"\x00" * (nw * 4 - msg_bytes), "<u4")
                     for m in msgs])
    return msgs, rows


def _tagged_digests(rows, msg_bytes, digest_bytes, tag):
    return digest_rows_to_bytes(
        blake2b_rows(torch.from_numpy(rows.view(np.int32).copy()), msg_bytes,
                     digest_bytes, tag), digest_bytes)


# the message shapes of tests/test_device_blake2b.py plus 127 bytes (the tag
# and the message fill one block exactly), at both digest sizes
@pytest.mark.parametrize("msg_bytes", [0, 4, 124, 127, 128, 132, 385])
@pytest.mark.parametrize("digest_bytes", [8, 32])
@pytest.mark.parametrize("tag", [0x00, 0x01])
def test_tagged_rows_match_hashlib(msg_bytes, digest_bytes, tag):
    rng = np.random.default_rng(msg_bytes * 64 + digest_bytes + tag)
    msgs, rows = _rows(rng, 5, msg_bytes)
    assert _tagged_digests(rows, msg_bytes, digest_bytes, tag) == [
        hashlib.blake2b(bytes([tag]) + m, digest_size=digest_bytes).digest()
        for m in msgs]


#: sha256 of the reference's outputs (little-endian uint32 words or digest
#: bytes) per case: its tagged rows per (msg_bytes, digest_bytes), its
#: Merkle heap, its unsalted leaf pipeline (root and heap) and its salted
#: leaf digests.  Their jitted functions cost an XLA CPU compile each;
#: the slow test recomputes them.
REFERENCE_PINS = {
    ("rows", 4, 8):
        "d49446f5bcf344a0184db680daf47ebcb01d6d509bf20303caaac6d6c9abbd57",
    ("rows", 128, 32):
        "2b76eb235117a5c3ec9455371ced0ceca987ed514eeaecf3c59e3f4d3824f0cd",
    ("rows", 385, 32):
        "38d1006c6d847f5cd4d6aaa704eb1b11e80e76c1cb46013c7cb5d9b3084c4446",
    "heap":
        "ec0bfd8646f38068a319646447778b47b42415db94f7075a0ec461be6ccf6829",
    "pipeline":
        "11fb6e528a77a05766d03687872ae70e6eee242dfbc7a25881bc1529f9a9d2f7",
    "salted":
        "552892dbf3f2c3c25ac02e48ab020d28e401ca80647c40d73aa6260fe64b9110",
}


def _sha(blobs):
    return hashlib.sha256(b"".join(blobs)).hexdigest()


def _reference_rows(msg_bytes, digest_bytes):
    msgs, rows = _rows(np.random.default_rng(msg_bytes), 5, msg_bytes)
    ref = np.asarray(jax.jit(lambda w: blake2b_words(
        prefix_tag_words(w, 0x00), msg_bytes + 1, digest_bytes))(
            jnp.asarray(rows)))
    return [ref[k].astype("<u4").tobytes() for k in range(len(msgs))]


# one block, a block boundary crossed by the tag byte, and four blocks
@pytest.mark.parametrize("msg_bytes,digest_bytes", [(4, 8), (128, 32),
                                                    (385, 32)])
def test_tagged_rows_match_reference(msg_bytes, digest_bytes):
    msgs, rows = _rows(np.random.default_rng(msg_bytes), 5, msg_bytes)
    assert _sha(_tagged_digests(rows, msg_bytes, digest_bytes, 0x00)) == \
        REFERENCE_PINS[("rows", msg_bytes, digest_bytes)]


def _heap_leaves():
    rng = np.random.default_rng(11)
    return rng.integers(0, 1 << 32, size=(4, 8), dtype=np.uint64).astype(
        np.uint32)


def _reference_heap():
    return [np.asarray(jax.jit(lambda d: merkle_heap_words(d, 32))(
        jnp.asarray(_heap_leaves()))).astype("<u4").tobytes()]


def test_merkle_heap_matches_reference():
    got = merkle_heap(torch.from_numpy(_heap_leaves().view(np.int32).copy()),
                      32)
    assert _sha([got.numpy().astype("<u4").tobytes()]) == \
        REFERENCE_PINS["heap"]


def _leaf_pipeline_inputs(salt_bytes):
    """2 oracles over 16 points in cosets of 4 (4 leaves), and salt_bytes
    of salt per leaf when > 0."""
    Fj, Ft = jax_edwards_fr(), edwards_fr()
    dj = jax_make_domain(Fj, 4, shift=jax_outside(Fj, 4))
    dt = make_domain(Ft, 4, shift=element_outside_of_subset(Ft, 4))
    rng = np.random.default_rng(4)
    evals = [Fj.from_ints_np(Ft.random_ints(16, rng)) for _ in range(2)]
    salts = rng.bytes(4 * salt_bytes) if salt_bytes else None
    root_t, heap_t, blocks_t = common.device_leaf_digests(
        Ft, [limbs_from_numpy(e) for e in evals], dt, 4, 32, salts=salts)
    host_blocks = common.serialize_leaf_blocks(
        Ft, [limbs_from_numpy(e) for e in evals], dt, 4)
    assert blocks_t.gather(range(len(blocks_t))) == host_blocks
    hasher = Blake2bHashing(128)
    sb = salt_bytes
    assert digest_rows_to_bytes(heap_t[len(blocks_t):], 32) == \
        [hasher.leaf_hash(b + (salts[k * sb:(k + 1) * sb] if sb else b""))
         for k, b in enumerate(host_blocks)]
    return Fj, dj, evals, salts, root_t, heap_t


def _reference_pipeline():
    Fj, dj, evals, _, _, _ = _leaf_pipeline_inputs(0)
    root_j, heap_j, _ = jcommon.device_leaf_digests(
        Fj, [jnp.asarray(e) for e in evals], dj, 4, 32, build_tree=True)
    return [root_j, np.asarray(heap_j).astype("<u4").tobytes()]


def _reference_salted():
    Fj, dj, evals, salts, _, _ = _leaf_pipeline_inputs(8)
    digests_j, _ = jcommon.device_leaf_digests(
        Fj, [jnp.asarray(e) for e in evals], dj, 4, 32, salts=salts)
    return list(digests_j)


def test_device_leaf_pipeline_matches_reference():
    """The port's leaf pipeline and Merkle heap against the JAX package's
    (its pin), the host serialization and hashlib."""
    _, _, _, _, root_t, heap_t = _leaf_pipeline_inputs(0)
    assert _sha([root_t, heap_t.numpy().astype("<u4").tobytes()]) == \
        REFERENCE_PINS["pipeline"]


def test_salted_device_leaf_pipeline_matches_reference():
    """zk leaves, 0x00 || block || salt with 8-byte salts (32-bit
    security): the leaf digests against the JAX package's (its leaf
    pipeline without the tree, which the unsalted case covers; its pin),
    the host serialization and hashlib."""
    _, _, _, _, _, heap_t = _leaf_pipeline_inputs(8)
    assert _sha(digest_rows_to_bytes(heap_t[4:], 32)) == \
        REFERENCE_PINS["salted"]


def _reference_cases():
    """(pin key, reference outputs, port outputs) of every pinned case."""
    cases = []
    for m, d in ((4, 8), (128, 32), (385, 32)):
        _, rows = _rows(np.random.default_rng(m), 5, m)
        cases.append((("rows", m, d), _reference_rows(m, d),
                      _tagged_digests(rows, m, d, 0x00)))
    cases.append(("heap", _reference_heap(), [merkle_heap(torch.from_numpy(
        _heap_leaves().view(np.int32).copy()), 32).numpy().astype(
            "<u4").tobytes()]))
    _, _, _, _, root_t, heap_t = _leaf_pipeline_inputs(0)
    cases.append(("pipeline", _reference_pipeline(),
                  [root_t, heap_t.numpy().astype("<u4").tobytes()]))
    _, _, _, _, _, heap_t = _leaf_pipeline_inputs(8)
    cases.append(("salted", _reference_salted(),
                  digest_rows_to_bytes(heap_t[4:], 32)))
    return cases


@pytest.mark.slow
def test_reference_outputs_behind_the_pins():
    for key, want, got in _reference_cases():
        assert got == want, key
        assert _sha(want) == REFERENCE_PINS[key], key


@pytest.mark.parametrize("positions", [[0], [3, 3, 9], [1, 2, 5, 14, 15],
                                       list(range(16))])
def test_multi_proof_round_trip(positions):
    Ft = edwards_fr()
    dt = make_domain(Ft, 5, shift=element_outside_of_subset(Ft, 5))
    rng = np.random.default_rng(len(positions))
    evals = [Ft.random((32,), rng, "cpu") for _ in range(2)]
    root, heap, blocks = common.device_leaf_digests(Ft, evals, dt, 2, 32)
    hasher = Blake2bHashing(128)
    mt = MerkleTree.from_device_heap(hasher, 16, heap, root)
    leaves = sorted(set(positions))
    aux = mt.multi_proof(positions)
    revealed = blocks.gather(leaves)
    assert validate_multi_proof(hasher, root, 16, positions, revealed, aux)
    bad = bytearray(revealed[0])
    bad[0] ^= 1
    assert not validate_multi_proof(hasher, root, 16, positions,
                                    [bytes(bad)] + revealed[1:], aux)
    if aux:
        assert not validate_multi_proof(hasher, root, 16, positions, revealed,
                                        aux[:-1])


def test_leaf_pipeline_packs_16_limbs():
    """The BLAKE2b leaf pipeline over alt_bn128_Fr (16 limbs packed into 8
    words per element): the device blocks are the host serialization and
    the leaf digests hashlib's."""
    Fb = alt_bn128_fr()
    dt = make_domain(Fb, 5, shift=element_outside_of_subset(Fb, 5))
    rng = np.random.default_rng(16)
    evals = [Fb.random((32,), rng, "cpu") for _ in range(2)]
    root, heap, blocks = common.device_leaf_digests(Fb, evals, dt, 2, 32)
    host = common.serialize_leaf_blocks(Fb, evals, dt, 2)
    assert blocks.gather(range(16)) == host
    hasher = Blake2bHashing(128)
    assert digest_rows_to_bytes(heap[16:], 32) == [hasher.leaf_hash(b)
                                                   for b in host]
