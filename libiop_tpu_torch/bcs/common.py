"""Shared BCS machinery: parameters, the BLAKE2b device leaf pipeline, leaf
serialization and the transcript (port of libiop_tpu/bcs/common.py,
multiplicative branch: BLAKE2b and Poseidon trees, zk salts included; each
hash suite builds its trees through its ``device_leaf_digests``, the
Poseidon one in bcs/poseidon.py).

Leaf layout (bcs_common.tcc:646-676): with coset size c over a domain of size
N, leaf j holds, for each oracle in ascending id order, the values at
positions j, j + N/c, ..., j + (c-1)N/c (a multiplicative coset) or
j*c, ..., j*c + c-1 (an affine subspace, whose cosets are contiguous) as
canonical little-endian bytes: 16-bit limbs of a prime field element, the
32-bit words of a binary one.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.blake2b import blake2b_rows, digest_rows_to_bytes, merkle_heap
from .hashing import Blake2bHashchain, Blake2bHashing
from .poseidon import PoseidonHashchain, PoseidonHashing
from .pow import PowParameters

#: the algebraic hashes (hash_enum.hpp:21-27): Cauchy-MDS alpha 5, and the
#: near-MDS alpha 17 variant
POSEIDON_HASHES = ("poseidon", "poseidon_high_alpha")


@dataclasses.dataclass
class BCSParameters:
    security_bits: int = 128
    #: "blake2b" | "poseidon" | "poseidon_high_alpha"
    hash_name: str = "blake2b"
    pow_bits: int = 0

    def make_hasher(self, field):
        """The leaf / two-to-one hash suite; Poseidon works over ``field``."""
        if self.hash_name in POSEIDON_HASHES:
            return PoseidonHashing(field, self.security_bits,
                                   variant=self.hash_name)
        if self.hash_name != "blake2b":
            raise ValueError(f"unknown hash {self.hash_name!r}")
        return Blake2bHashing(self.security_bits)

    def make_hashchain(self, field):
        if self.hash_name in POSEIDON_HASHES:
            return PoseidonHashchain(field, self.security_bits,
                                     variant=self.hash_name)
        return Blake2bHashchain(field, self.security_bits)

    def make_pow(self) -> PowParameters:
        return PowParameters(self.pow_bits)


class DeviceLeafBlocks:
    """Leaf blocks kept on the device as (num_leaves, nw) int32 word rows
    (little-endian byte streams whose first block_len bytes are the block;
    a zk row carries its salt after it); bytes reach the host only for the
    queried leaves."""

    __slots__ = ("words", "block_len")

    def __init__(self, words: torch.Tensor, block_len: int):
        self.words = words
        self.block_len = block_len

    def __len__(self) -> int:
        return self.words.shape[0]

    def gather(self, positions) -> List[bytes]:
        idx = torch.as_tensor(list(positions), dtype=torch.int64,
                              device=self.words.device)
        return digest_rows_to_bytes(self.words.index_select(0, idx),
                                    self.block_len)


def pack_canonical_words(F, stacked: torch.Tensor) -> torch.Tensor:
    """(L, *batch) Montgomery limbs -> (L/2, *batch) int32 words whose
    little-endian bytes are the canonical little-endian limb bytes; a
    binary field's words are canonical as they are."""
    if F.kind == "additive":
        return stacked
    cl = F.to_canonical_limbs(stacked).to(torch.int64)
    w = cl[0::2] | (cl[1::2] << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def leaf_words_layout(packed: torch.Tensor, num_leaves: int, coset_size: int,
                      contiguous: bool = False):
    """(L2, O, N) packed words -> (num_leaves, O*c*L2) per-leaf word streams
    (leaf j = for each oracle, positions j + i*num_leaves, i < c; with
    ``contiguous``, positions j*c + i)."""
    L2, O, N = packed.shape
    assert N == num_leaves * coset_size
    if contiguous:
        w = packed.reshape(L2, O, num_leaves, coset_size).permute(2, 1, 3, 0)
    else:
        w = packed.reshape(L2, O, coset_size, num_leaves).permute(3, 1, 2, 0)
    return w.reshape(num_leaves, O * coset_size * L2).contiguous()


def device_leaf_digests(F, oracle_evals_list, domain, coset_size: int,
                        digest_bytes: int, salts: Optional[bytes] = None):
    """Device leaf pipeline: canonicalize + pack -> per-leaf word layout ->
    tagged BLAKE2b leaf digests (K3, tag 0x00) -> every Merkle level (K3,
    tag 0x01).  Returns (root bytes, heap (2n, dw) tensor, DeviceLeafBlocks).

    zk trees (merkle_tree.tcc:37-67): ``salts`` is the host's secret blob of
    num_leaves * salt_bytes (word-aligned).  It is shipped to the device
    once and written after each leaf's words, so K3 hashes
    0x00 || block || salt, the stream the host verifier hashes."""
    assert oracle_evals_list and digest_bytes % 4 == 0 \
        and (F.kind == "additive" or F.L % 2 == 0)
    N = domain.num_elements()
    num_leaves = N // coset_size
    packed = pack_canonical_words(F, torch.stack(oracle_evals_list, dim=1))
    words = leaf_words_layout(packed, num_leaves, coset_size,
                              domain.kind == "affine_subspace")
    block_len = 4 * words.shape[1]
    if salts is not None:
        sb = len(salts) // num_leaves
        assert sb % 4 == 0 and len(salts) == num_leaves * sb, len(salts)
        salt_words = torch.from_numpy(np.frombuffer(salts, "<i4").reshape(
            num_leaves, sb // 4).copy()).to(words.device)
        words = torch.cat([words, salt_words], dim=1)
    digests = blake2b_rows(words, 4 * words.shape[1], digest_bytes, 0x00)
    heap = merkle_heap(digests, digest_bytes)
    root = digest_rows_to_bytes(heap[1:2], digest_bytes)[0]
    return root, heap, DeviceLeafBlocks(words, block_len)


def serialize_leaf_blocks(F, oracle_evals_list, domain,
                          coset_size: int) -> List[bytes]:
    """Host serialization of a (round, domain)'s oracles into leaf bytes,
    the layout the device pipeline hashes."""
    N = domain.num_elements()
    num_leaves = N // coset_size
    raw_per_oracle = []
    for ev in oracle_evals_list:
        raw = np.frombuffer(F.canonical_to_bytes(F.to_canonical_limbs(ev)),
                            dtype=np.uint8).reshape(N, F.elem_bytes)
        if domain.kind == "affine_subspace":
            blocks = raw.reshape(num_leaves, coset_size, F.elem_bytes)
        else:
            blocks = raw.reshape(coset_size, num_leaves,
                                 F.elem_bytes).transpose(1, 0, 2)
        raw_per_oracle.append(blocks.reshape(num_leaves, -1))
    cat = np.ascontiguousarray(np.concatenate(raw_per_oracle, axis=1))
    return [cat[i].tobytes() for i in range(num_leaves)]


def parse_leaf_block(F, block: bytes, num_oracles: int,
                     coset_size: int) -> List[List[int]]:
    """values[oracle_idx][intra_coset_idx] of one leaf, canonical ints."""
    eb = F.elem_bytes
    assert len(block) == num_oracles * coset_size * eb
    out = []
    off = 0
    for _ in range(num_oracles):
        vals = []
        for _ in range(coset_size):
            vals.append(int.from_bytes(block[off:off + eb], "little"))
            off += eb
        out.append(vals)
    return out


@dataclasses.dataclass
class MTProof:
    """Revealed data for one Merkle tree."""
    positions: List[int]
    leaf_blocks: List[bytes]
    aux_digests: List[bytes]
    salts: Optional[List[bytes]] = None


@dataclasses.dataclass
class BCSTranscript:
    """The SNARG; byte format identical to the JAX package's."""
    mt_roots: Dict[Tuple[int, int], bytes] = dataclasses.field(default_factory=dict)
    prover_messages: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    mt_proofs: Dict[Tuple[int, int], MTProof] = dataclasses.field(default_factory=dict)
    pow_nonce: int = 0
    elem_bytes: int = 0

    def serialize(self) -> bytes:
        out = [b"BCS2"]

        def put_bytes(b: bytes):
            out.append(struct.pack("<I", len(b)))
            out.append(b)

        eb = self.elem_bytes
        assert eb > 0, "transcript elem_bytes must be set before serialization"
        out.append(struct.pack("<I", eb))
        out.append(struct.pack("<Q", self.pow_nonce))
        out.append(struct.pack("<I", len(self.mt_roots)))
        for (rnd, dom), root in sorted(self.mt_roots.items()):
            out.append(struct.pack("<II", rnd, dom))
            put_bytes(root)
        out.append(struct.pack("<I", len(self.prover_messages)))
        for mid in sorted(self.prover_messages):
            vals = self.prover_messages[mid]
            out.append(struct.pack("<II", mid, len(vals)))
            for v in vals:
                out.append(int(v).to_bytes(eb, "little"))
        out.append(struct.pack("<I", len(self.mt_proofs)))
        for (rnd, dom), prf in sorted(self.mt_proofs.items()):
            out.append(struct.pack("<II", rnd, dom))
            out.append(struct.pack("<I", len(prf.positions)))
            for p in prf.positions:
                out.append(struct.pack("<Q", p))
            out.append(struct.pack("<I", len(prf.leaf_blocks)))
            for b in prf.leaf_blocks:
                put_bytes(b)
            out.append(struct.pack("<I", len(prf.aux_digests)))
            for b in prf.aux_digests:
                put_bytes(b)
            has_salts = prf.salts is not None
            out.append(struct.pack("<B", 1 if has_salts else 0))
            if has_salts:
                out.append(struct.pack("<I", len(prf.salts)))
                for s in prf.salts:
                    put_bytes(s)
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "BCSTranscript":
        assert data[:4] == b"BCS2"
        off = 4

        def get(fmt):
            nonlocal off
            vals = struct.unpack_from(fmt, data, off)
            off += struct.calcsize(fmt)
            return vals

        def get_bytes() -> bytes:
            nonlocal off
            (n,) = get("<I")
            b = data[off:off + n]
            off += n
            return b

        t = cls()
        (t.elem_bytes,) = get("<I")
        eb = t.elem_bytes
        (t.pow_nonce,) = get("<Q")
        (nroots,) = get("<I")
        for _ in range(nroots):
            rnd, dom = get("<II")
            t.mt_roots[(rnd, dom)] = get_bytes()
        (nmsgs,) = get("<I")
        for _ in range(nmsgs):
            mid, nvals = get("<II")
            vals = []
            for _ in range(nvals):
                vals.append(int.from_bytes(data[off:off + eb], "little"))
                off += eb
            t.prover_messages[mid] = vals
        (nproofs,) = get("<I")
        for _ in range(nproofs):
            rnd, dom = get("<II")
            (npos,) = get("<I")
            positions = [get("<Q")[0] for _ in range(npos)]
            (nblk,) = get("<I")
            blocks = [get_bytes() for _ in range(nblk)]
            (naux,) = get("<I")
            aux = [get_bytes() for _ in range(naux)]
            (has_salts,) = get("<B")
            salts = None
            if has_salts:
                (ns,) = get("<I")
                salts = [get_bytes() for _ in range(ns)]
            t.mt_proofs[(rnd, dom)] = MTProof(positions, blocks, aux, salts)
        return t

    def argument_size_bytes(self) -> int:
        return len(self.serialize())

    def detailed_report(self) -> dict:
        """Per-tree cost breakdown: IOP bytes (revealed oracle values and
        prover messages) against BCS overhead (roots, auxiliary digests,
        salts, the pow nonce); the reference's
        print_detailed_transcript_data (bcs_common.tcc:698-827)."""
        per_tree = {}
        iop_bytes = 0
        bcs_bytes = 0
        for key, prf in sorted(self.mt_proofs.items()):
            leaf_bytes = sum(len(b) for b in prf.leaf_blocks)
            digest_bytes = sum(len(d) for d in prf.aux_digests)
            salt_bytes = sum(len(s) for s in (prf.salts or []))
            root_bytes = len(self.mt_roots.get(key, b""))
            per_tree[key] = {
                "revealed_leaves": len(prf.positions),
                "leaf_bytes": leaf_bytes,
                "aux_digests": len(prf.aux_digests),
                "digest_bytes": digest_bytes + root_bytes,
                "salt_bytes": salt_bytes,
            }
            iop_bytes += leaf_bytes
            bcs_bytes += digest_bytes + salt_bytes + root_bytes
        msg_bytes = sum(len(vals) * self.elem_bytes
                        for vals in self.prover_messages.values())
        iop_bytes += msg_bytes
        bcs_bytes += 8  # pow nonce
        return {
            "per_tree": per_tree,
            "prover_message_bytes": msg_bytes,
            "iop_bytes": iop_bytes,
            "bcs_overhead_bytes": bcs_bytes,
            "total_serialized_bytes": self.argument_size_bytes(),
        }

    def print_detailed_report(self):
        rep = self.detailed_report()
        print(f"{'tree (round,domain)':>22} | leaves | leaf B | aux | "
              "digest B | salt B")
        for key, row in rep["per_tree"].items():
            print(f"{str(key):>22} | {row['revealed_leaves']:6d} | "
                  f"{row['leaf_bytes']:6d} | {row['aux_digests']:3d} | "
                  f"{row['digest_bytes']:8d} | {row['salt_bytes']:6d}")
        print(f"prover messages: {rep['prover_message_bytes']} B")
        print(f"IOP bytes: {rep['iop_bytes']}  BCS overhead: "
              f"{rep['bcs_overhead_bytes']}  total: "
              f"{rep['total_serialized_bytes']}")
