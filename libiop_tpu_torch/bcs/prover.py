"""BCS prover: the Fiat-Shamir side of the IOP engine (port of
libiop_tpu/bcs/prover.py).

``signal_prover_round_done`` builds one Merkle tree per (round, domain) on
the device (BLAKE2b leaves and levels through K3, Poseidon through K9),
absorbs roots and messages into the hashchain (BLAKE2b or the Poseidon
sponge) and squeezes the round's verifier randomness; after the last round
it grinds the pow (BLAKE2b for every hash, as the reference's).
A tree holding a zk oracle is salted: one ``secrets.token_bytes`` blob per
such tree, in tree order, as the reference draws it.  Trees preloaded
from a holographic index (``preload_index_trees``) are rehydrated from
their nodes, with no leaf serialized or hashed.  ``get_transcript``
replays every registered query, collects the real-oracle positions per tree
and builds pruned multi-proofs (with the queried leaves' salts).
"""
from __future__ import annotations

import secrets
from typing import Dict, List, Set, Tuple

from ..iop.runtime import IOPProtocol, OracleHandle
from ..utils.profiling import PROFILER
from .common import BCSParameters, BCSTranscript, MTProof
from .merkle import MerkleTree


class BCSProver(IOPProtocol):
    def __init__(self, field, params: BCSParameters, device):
        super().__init__(field, device)
        self.params = params
        self.hasher = params.make_hasher(field)
        self.hashchain = params.make_hashchain(field)
        self.pow = params.make_pow()
        self.merkle_trees: Dict[Tuple[int, int], MerkleTree] = {}
        # DeviceLeafBlocks (BLAKE2b) or DeviceLeafColumns (Poseidon)
        self.mt_leaf_blocks: Dict[Tuple[int, int], object] = {}
        self.mt_roots: Dict[Tuple[int, int], bytes] = {}
        self.pow_nonce = 0
        self._preloaded_trees: Dict[Tuple[int, int], tuple] = {}

    def preload_index_trees(self, mt_data: Dict[Tuple[int, int], tuple]):
        """Install persisted round-0 trees {(0, domain id): (leaf blocks,
        node heap)}, so the index round costs no hashing."""
        self._preloaded_trees = dict(mt_data)

    def _round_oracle_groups(self, rnd: int) -> List[Tuple[int, List[int]]]:
        """[(domain_id, [oracle ids])] of a round, both ascending."""
        groups: Dict[int, List[int]] = {}
        for i, reg in enumerate(self.oracle_regs):
            if reg.round == rnd:
                groups.setdefault(reg.domain.id, []).append(i)
        return sorted((d, sorted(ids)) for d, ids in groups.items())

    def signal_prover_round_done(self):
        rnd = self._rounds_done
        super().signal_prover_round_done()
        rp = self.get_round_parameters(rnd)
        for dom_id, oracle_ids in self._round_oracle_groups(rnd):
            dom = self.domains[dom_id]
            num_leaves = dom.num_elements() // rp.quotient_map_size
            preloaded = self._preloaded_trees.get((rnd, dom_id))
            if preloaded is not None:
                blocks, heap = preloaded
                mt = MerkleTree.from_nodes(self.hasher, num_leaves, heap)
                root = mt.root
            else:
                evals = [self.oracle_evals[i] for i in oracle_ids]
                salts = None
                if any(self.oracle_regs[i].make_zk for i in oracle_ids):
                    salts = secrets.token_bytes(
                        num_leaves * self.hasher.salt_bytes)
                with PROFILER.block(f"leaf_hash_dev_r{rnd}_d{dom_id}"):
                    root, heap, blocks = self.hasher.device_leaf_digests(
                        self.F, evals, dom, rp.quotient_map_size, salts=salts)
                mt = MerkleTree.from_device_heap(self.hasher, num_leaves,
                                                 heap, root, salts=salts)
            self.merkle_trees[(rnd, dom_id)] = mt
            self.mt_leaf_blocks[(rnd, dom_id)] = blocks
            self.mt_roots[(rnd, dom_id)] = root
            self.hashchain.absorb_root(root)
        msg_vals: List[int] = []
        for i, reg in enumerate(self.prover_msg_regs):
            if reg.round == rnd:
                msg_vals.extend(self.prover_messages[i])
        self.hashchain.absorb_field_elements(msg_vals)
        for i, reg in enumerate(self.verifier_msg_regs):
            if reg.round == rnd:
                self.verifier_messages[i] = \
                    self.hashchain.squeeze_field_elements(reg.size)
        if rnd == self.num_interaction_rounds - 1:
            with PROFILER.block("pow_solve"):
                self.pow_nonce = self.pow.solve(self.hashchain.state)
            self.hashchain.absorb_bytes(
                b"pow" + self.pow_nonce.to_bytes(8, "little"))

    def _fresh_verifier_randomness(self, size: int, index: int):
        raise RuntimeError("BCS prover randomness must come from the hashchain")

    def finalize_query_positions(self):
        """Squeeze all random query positions in registration order."""
        assert self._rounds_done == self.num_interaction_rounds
        for i, (kind, payload) in enumerate(self.qpos_regs):
            if kind == "random" and i not in self._qpos_values:
                dom = self.get_domain(payload)
                self._qpos_values[i] = self.hashchain.squeeze_query_positions(
                    1, dom.num_elements())[0]

    def _fresh_query_position(self, domain_size: int, index: int) -> int:
        raise RuntimeError("BCS query positions must be squeezed via "
                           "finalize_query_positions")

    def _real_positions_needed(self) -> Set[Tuple[int, int]]:
        needed: Set[Tuple[int, int]] = set()

        def walk(handle: OracleHandle, pos: int):
            if handle.virtual:
                for c in self.virtual_regs[handle.id].constituents:
                    walk(c, pos)
            else:
                needed.add((handle.id, pos))

        for oracle_h, pos_h in self.query_regs:
            walk(oracle_h, self.obtain_query_position(pos_h))
        return needed

    def get_transcript(self) -> BCSTranscript:
        with PROFILER.block("transcript_assembly"):
            self.finalize_query_positions()
            t = BCSTranscript()
            t.elem_bytes = self.F.elem_bytes
            t.mt_roots = dict(self.mt_roots)
            t.prover_messages = {i: list(v)
                                 for i, v in self.prover_messages.items()}
            t.pow_nonce = self.pow_nonce
            per_tree: Dict[Tuple[int, int], Set[int]] = {}
            for oid, pos in self._real_positions_needed():
                reg = self.oracle_regs[oid]
                rp = self.get_round_parameters(reg.round)
                dom = self.domains[reg.domain.id]
                per_tree.setdefault((reg.round, reg.domain.id), set()).add(
                    dom.coset_index(pos, rp.quotient_map_size))
            for key, leaf_positions in sorted(per_tree.items()):
                positions = sorted(leaf_positions)
                mt = self.merkle_trees[key]
                t.mt_proofs[key] = MTProof(
                    positions=positions,
                    leaf_blocks=self.mt_leaf_blocks[key].gather(positions),
                    aux_digests=mt.multi_proof(positions),
                    salts=mt.reveal_salts(positions) if mt.make_zk else None)
            return t
