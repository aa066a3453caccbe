"""BCS verifier: validates a transcript and serves the IOP verifier's queries
(port of libiop_tpu/bcs/verifier.py).

``seal_interaction_registrations`` replays the hashchain from the
transcript's roots and prover messages to rebuild all verifier randomness,
checks the pow, validates every pruned multi-proof (salted leaves for trees
of zk oracles) and installs the revealed values in an (oracle, position) ->
value map.  Real-oracle queries are served from the map (an unrevealed
position raises); virtual oracles recurse through their pointwise
definitions.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..iop.runtime import IOPProtocol, OracleHandle
from .common import BCSParameters, BCSTranscript, parse_leaf_block
from .merkle import validate_multi_proof


class BCSVerificationError(Exception):
    pass


class BCSVerifier(IOPProtocol):
    def __init__(self, field, params: BCSParameters,
                 transcript: BCSTranscript, device):
        super().__init__(field, device)
        self.params = params
        self.hasher = params.make_hasher(field)
        self.hashchain = params.make_hashchain(field)
        self.pow = params.make_pow()
        self.transcript = transcript
        self._valid = None
        self._value_map: Dict[Tuple[int, int], int] = {}

    def seal_interaction_registrations(self):
        super().seal_interaction_registrations()
        self.prover_messages = {i: list(v) for i, v in
                                self.transcript.prover_messages.items()}
        try:
            self._replay_hashchain()
            self._validate_merkle_proofs()
            self._valid = True
        except BCSVerificationError:
            self._valid = False

    def transcript_is_valid(self) -> bool:
        assert self._valid is not None
        return self._valid

    def _replay_hashchain(self):
        t = self.transcript
        for rnd in range(self.num_interaction_rounds):
            for dom_id in sorted({reg.domain.id for reg in self.oracle_regs
                                  if reg.round == rnd}):
                root = t.mt_roots.get((rnd, dom_id))
                if root is None:
                    raise BCSVerificationError(f"missing MT root for round {rnd}")
                self.hashchain.absorb_root(root)
            msg_vals = []
            for i, reg in enumerate(self.prover_msg_regs):
                if reg.round == rnd:
                    vals = t.prover_messages.get(i)
                    if vals is None or len(vals) != reg.size:
                        raise BCSVerificationError(f"bad prover message {i}")
                    if any(v < 0 or v >= self.F.field_size for v in vals):
                        raise BCSVerificationError(
                            f"non-canonical prover message {i}")
                    msg_vals.extend(vals)
            self.hashchain.absorb_field_elements(msg_vals)
            for i, reg in enumerate(self.verifier_msg_regs):
                if reg.round == rnd:
                    self.verifier_messages[i] = \
                        self.hashchain.squeeze_field_elements(reg.size)
        if not self.pow.verify(self.hashchain.state, t.pow_nonce):
            raise BCSVerificationError("pow verification failed")
        self.hashchain.absorb_bytes(b"pow" + t.pow_nonce.to_bytes(8, "little"))
        self._rounds_done = self.num_interaction_rounds

    def _validate_merkle_proofs(self):
        t = self.transcript
        groups: Dict[Tuple[int, int], list] = {}
        for i, reg in enumerate(self.oracle_regs):
            groups.setdefault((reg.round, reg.domain.id), []).append(i)
        for key, prf in t.mt_proofs.items():
            rnd, dom_id = key
            oracle_ids = sorted(groups.get(key, []))
            if not oracle_ids:
                raise BCSVerificationError(f"proof for unknown tree {key}")
            c = self.get_round_parameters(rnd).quotient_map_size
            dom = self.domains[dom_id]
            num_leaves = dom.num_elements() // c
            root = t.mt_roots.get(key)
            if root is None:
                raise BCSVerificationError(f"missing root for tree {key}")
            expected_len = len(oracle_ids) * c * self.F.elem_bytes
            if any(len(b) != expected_len for b in prf.leaf_blocks):
                raise BCSVerificationError("bad leaf block size")
            if any(p < 0 or p >= num_leaves for p in prf.positions):
                raise BCSVerificationError("leaf position out of range")
            make_zk = any(self.oracle_regs[i].make_zk for i in oracle_ids)
            if make_zk and prf.salts is None:
                raise BCSVerificationError("missing zk salts")
            if not validate_multi_proof(
                    self.hasher, root, num_leaves, prf.positions,
                    prf.leaf_blocks, prf.aux_digests,
                    prf.salts if make_zk else None):
                raise BCSVerificationError(f"multiproof invalid for tree {key}")
            for leaf_pos, block in zip(prf.positions, prf.leaf_blocks):
                vals = parse_leaf_block(self.F, block, len(oracle_ids), c)
                for oi, oid in enumerate(oracle_ids):
                    for intra in range(c):
                        v = vals[oi][intra]
                        if v >= self.F.field_size:
                            raise BCSVerificationError(
                                "field element out of range")
                        pos = dom.position_by_coset_indices(leaf_pos, intra, c)
                        self._value_map[(oid, pos)] = v

    def finalize_query_positions(self):
        for i, (kind, payload) in enumerate(self.qpos_regs):
            if kind == "random" and i not in self._qpos_values:
                dom = self.get_domain(payload)
                self._qpos_values[i] = self.hashchain.squeeze_query_positions(
                    1, dom.num_elements())[0]

    def _fresh_query_position(self, domain_size: int, index: int) -> int:
        raise RuntimeError(
            "BCS query positions must come from finalize_query_positions")

    def _fresh_verifier_randomness(self, size: int, index: int):
        raise RuntimeError("BCS verifier randomness must come from the hashchain")

    def get_oracle_evaluation_at_position(self, handle: OracleHandle,
                                          position: int) -> int:
        if not handle.virtual:
            val = self._value_map.get((handle.id, position))
            if val is None:
                raise BCSVerificationError(
                    f"transcript does not contain oracle {handle.id} at {position}")
            return val
        return super().get_oracle_evaluation_at_position(handle, position)

    def get_oracle_evaluations(self, handle: OracleHandle):
        raise RuntimeError("the BCS verifier never sees full oracles")
