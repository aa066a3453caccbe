"""Merkle trees over oracle leaf columns, with pruned multi-membership proofs
(port of libiop_tpu/bcs/merkle.py, device-built trees).

A tree commits to all oracles of one (round, domain); its every level is
hashed on the device (K3 BLAKE2b, kernels/blake2b.py, or K9 Poseidon,
kernels/poseidon.py) into a heap with the root at index 1.  Multi-proofs
emit only the sibling digests not derivable from the queried set
(merkle_tree.tcc:244-337); the verifier mirrors the walk on the host
(merkle_tree.tcc:339-470).  A zk tree hashes each leaf block with a
secret salt appended and reveals the salts of the queried leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..device import resolve_device


class MerkleTree:
    """A device-built tree: ``heap`` is the hasher's heap layout (BLAKE2b:
    (2n, dw) digest words; Poseidon: (L, 2n) Montgomery digests) and
    ``hasher.heap_digests`` turns its nodes into digest bytes."""

    def __init__(self, hasher, num_leaves: int,
                 heap: torch.Tensor, root: bytes,
                 salts: Optional[bytes] = None):
        self.hasher = hasher
        self.num_leaves = num_leaves
        self.heap = heap
        self.root = root
        self.salts = salts
        self.make_zk = salts is not None
        self._nodes = None

    @classmethod
    def from_device_heap(cls, hasher, num_leaves: int, heap: torch.Tensor,
                         root: bytes, salts: Optional[bytes] = None
                         ) -> "MerkleTree":
        """Wrap a tree whose every level was hashed on the device; a zk
        tree keeps the salt blob (num_leaves * salt_bytes) its leaves were
        hashed with."""
        return cls(hasher, num_leaves, heap, root, salts)

    @classmethod
    def from_leaf_digests(cls, hasher, leaf_digests: List[bytes],
                          salts: Optional[List[bytes]] = None,
                          device="cuda") -> "MerkleTree":
        """A tree over precomputed leaf digests (bytes): its levels are
        hashed on the device.  A zk tree's caller made the salts, hashed
        them into the digests, and passes them here for reveal_salts."""
        n = len(leaf_digests)
        assert n >= 1 and (n & (n - 1)) == 0
        heap = hasher.heap_from_leaf_digests(leaf_digests,
                                             resolve_device(device))
        return cls(hasher, n, heap, hasher.heap_digests(heap, [1])[0],
                   None if salts is None else b"".join(salts))

    @classmethod
    def from_nodes(cls, hasher, num_leaves: int, heap: torch.Tensor
                   ) -> "MerkleTree":
        """Rehydrate a tree persisted by an indexer from its node heap (the
        layout ``from_device_heap`` keeps): no leaf is serialized or
        hashed, only the root is read back."""
        return cls(hasher, num_leaves, heap, hasher.heap_digests(heap, [1])[0])

    def materialize_nodes(self) -> List[bytes]:
        """The host node list in heap layout (nodes[1] the root, nodes[n:]
        the leaves, nodes[0] empty), read from the device heap once."""
        if self._nodes is None:
            self._nodes = self.hasher.heap_digests(
                self.heap, range(2 * self.num_leaves))
            self._nodes[0] = b""
        return self._nodes

    def reveal_salts(self, positions: Sequence[int]) -> List[bytes]:
        """The salts of the (sorted, deduplicated) leaf positions."""
        assert self.make_zk
        sb = len(self.salts) // self.num_leaves
        return [self.salts[p * sb:(p + 1) * sb] for p in sorted(set(positions))]

    @staticmethod
    def aux_node_ids(num_leaves: int, positions: Sequence[int]) -> List[int]:
        """Heap ids of the pruned proof's auxiliary digests in emission order
        (bottom-up layers, left to right)."""
        ids: List[int] = []
        node_ids = [num_leaves + p for p in sorted(set(positions))]
        while node_ids and node_ids[0] > 1:
            known = set(node_ids)
            parents = []
            for nid in node_ids:
                sib = nid ^ 1
                if sib in known:
                    if nid < sib:
                        parents.append(nid // 2)
                else:
                    ids.append(sib)
                    parents.append(nid // 2)
            node_ids = sorted(set(parents))
        return ids

    def multi_proof(self, positions: Sequence[int]) -> List[bytes]:
        """Pruned auxiliary digests for the (unsorted, possibly duplicated)
        leaf positions, gathered from the device heap."""
        return self.hasher.heap_digests(
            self.heap, self.aux_node_ids(self.num_leaves, positions))


def validate_multi_proof(hasher, root: bytes, num_leaves: int,
                         positions: Sequence[int], leaf_blocks: Sequence[bytes],
                         aux: Sequence[bytes],
                         salts: Optional[Sequence[bytes]] = None) -> bool:
    """Recompute the root from the claimed leaf blocks (sorted, deduplicated
    position order), their salts (zk trees) and the pruned auxiliary
    digests."""
    n = num_leaves
    frontier = sorted(set(positions))
    if not frontier or frontier[0] < 0 or frontier[-1] >= n:
        return False
    if len(frontier) != len(leaf_blocks):
        return False
    if salts is not None:
        if len(salts) != len(frontier):
            return False
        leaf_blocks = [b + s for b, s in zip(leaf_blocks, salts)]
    digests = {n + p: hasher.leaf_hash(b) for p, b in zip(frontier, leaf_blocks)}
    aux = list(aux)
    ai = 0
    node_ids = sorted(digests.keys())
    while node_ids and node_ids[0] > 1:
        parents = []
        known = set(node_ids)
        new_digests: Dict[int, bytes] = {}
        for nid in node_ids:
            sib = nid ^ 1
            if sib in known:
                if nid < sib:
                    new_digests[nid // 2] = hasher.two_to_one(
                        digests[nid], digests[sib])
                    parents.append(nid // 2)
            else:
                if ai >= len(aux):
                    return False
                sib_digest = aux[ai]
                ai += 1
                left, right = ((digests[nid], sib_digest) if nid % 2 == 0
                               else (sib_digest, digests[nid]))
                new_digests[nid // 2] = hasher.two_to_one(left, right)
                parents.append(nid // 2)
        digests = new_digests
        node_ids = sorted(set(parents))
    if ai != len(aux):
        return False
    return node_ids == [1] and digests[1] == root


def count_proof_hashes(num_leaves: int, positions: Sequence[int]) -> int:
    """Number of auxiliary digests a pruned proof of the leaf positions
    holds (merkle_tree.tcc:486+ role; the FRI argument-size optimizer's
    count)."""
    return len(MerkleTree.aux_node_ids(num_leaves, positions))
