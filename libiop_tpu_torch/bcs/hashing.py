"""Hashing for the BCS transformation: BLAKE2b leaf / 2-to-1 hashes and the
Fiat-Shamir hashchain (port of libiop_tpu/bcs/hashing.py).

Digests are 2*(security_bits/8) bytes.  The hashchain is sequential host
work on tiny data (hashlib); the bulk leaf and tree hashing of the prover
runs on the device (kernels/blake2b.py).  Field elements are always
serialized canonically (little-endian 16-bit limbs of a prime field, the
32-bit words of a binary one).
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels.blake2b import digest_rows_to_bytes, merkle_heap

DOMAIN_SEP = b"libiop-tpu/bcs/v1/"
LEAF_TAG = b"\x00"
NODE_TAG = b"\x01"


def blake2b(data: bytes, digest_size: int) -> bytes:
    return hashlib.blake2b(data, digest_size=digest_size).digest()


class Blake2bHashing:
    """Hash suite: leaf hash and 2-to-1 compression (host side)."""

    name = "blake2b"

    def __init__(self, security_bits: int = 128):
        self.security_bits = security_bits
        self.digest_bytes = 2 * (security_bits // 8)
        self.salt_bytes = 2 * (security_bits // 8)

    def leaf_hash(self, data: bytes) -> bytes:
        return blake2b(LEAF_TAG + data, self.digest_bytes)

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        return blake2b(NODE_TAG + left + right, self.digest_bytes)

    # -- host batches (the native OpenMP library, bcs/native_blake2b.py) ---
    def leaf_hash_batch_array(self, arr) -> Optional[List[bytes]]:
        """leaf_hash of each row of a contiguous (n, block_len) uint8
        array; None for an empty or non-2-D array."""
        from . import native_blake2b
        return native_blake2b.hash_batch_array(arr, self.digest_bytes,
                                               tag=LEAF_TAG)

    def leaf_hash_batch(self, blocks) -> List[bytes]:
        """leaf_hash of every block (one native batch when the blocks have
        one length)."""
        from . import native_blake2b
        out = native_blake2b.hash_batch(list(blocks), self.digest_bytes,
                                        tag=LEAF_TAG)
        if out is not None:
            return out
        return [self.leaf_hash(b) for b in blocks]

    def tree_layer(self, digests) -> List[bytes]:
        """two_to_one of each pair of consecutive digests."""
        from . import native_blake2b
        return native_blake2b.tree_layer(list(digests), self.digest_bytes,
                                         tag=NODE_TAG) or []

    def heap_from_leaf_digests(self, leaf_digests: Sequence[bytes], device
                               ) -> torch.Tensor:
        """The (2n, dw) device heap over leaf digests given as bytes: every
        level through K3 (kernels/blake2b.py merkle_heap)."""
        raw = np.frombuffer(b"".join(leaf_digests), dtype="<i4")
        words = torch.from_numpy(raw.reshape(len(leaf_digests), -1).copy())
        return merkle_heap(words.to(device), self.digest_bytes)

    def heap_digests(self, heap: torch.Tensor, ids: Sequence[int]
                     ) -> List[bytes]:
        """Host bytes of the nodes ``ids`` of a device heap (2n, dw) of
        digest words (kernels/blake2b.py merkle_heap)."""
        idx = torch.as_tensor(list(ids), dtype=torch.int64, device=heap.device)
        return digest_rows_to_bytes(heap.index_select(0, idx),
                                    self.digest_bytes)

    def device_leaf_digests(self, F, oracle_evals_list, domain,
                            coset_size: int, salts: Optional[bytes] = None):
        """Device tree of a (round, domain): BLAKE2b leaves and levels
        through K3 (bcs.common.device_leaf_digests, which imports this
        module).  Returns (root bytes, heap, DeviceLeafBlocks)."""
        from .common import device_leaf_digests
        return device_leaf_digests(F, oracle_evals_list, domain, coset_size,
                                   self.digest_bytes, salts=salts)


class Blake2bHashchain:
    """Sequential Fiat-Shamir state: absorb(x) sets state = H(state || x);
    the squeeze counter resets on every absorb."""

    def __init__(self, field, security_bits: int = 128):
        self.F = field
        self.digest_bytes = 2 * (security_bits // 8)
        self.state = blake2b(DOMAIN_SEP + b"hashchain-init", self.digest_bytes)
        self._squeeze_ctr = 0
        # a prime field draws 128 bits of slack for its reduction mod p; a
        # binary field's exact width is uniform
        self._sample_bytes = min(64, field.elem_bytes + (
            0 if field.kind == "additive" else 16))

    def absorb_bytes(self, data: bytes):
        self.state = blake2b(self.state + data, self.digest_bytes)
        self._squeeze_ctr = 0

    def absorb_root(self, root: bytes):
        self.absorb_bytes(b"root" + root)

    def absorb_field_elements(self, values: Sequence[int]):
        """Zero-prefixed concatenation of canonical elements."""
        eb = self.F.elem_bytes
        data = b"\x00" * eb + b"".join(
            self.F.sample_int(int(v)).to_bytes(eb, "little") for v in values)
        self.absorb_bytes(b"msgs" + data)

    def _squeeze_block(self, nbytes: int) -> bytes:
        out = blake2b(self.state + b"squeeze"
                      + self._squeeze_ctr.to_bytes(8, "little"), min(64, nbytes))
        self._squeeze_ctr += 1
        return out

    def squeeze_field_elements(self, n: int) -> List[int]:
        return [self.F.sample_int(int.from_bytes(
            self._squeeze_block(self._sample_bytes), "little"))
            for _ in range(n)]

    def squeeze_query_positions(self, n: int, domain_size: int) -> List[int]:
        """n positions in [0, domain_size), domain_size a power of two."""
        assert domain_size & (domain_size - 1) == 0
        return [int.from_bytes(self._squeeze_block(8), "little")
                & (domain_size - 1) for _ in range(n)]
