"""Poseidon permutation, algebraic sponge, leaf/2-to-1 hashing and the
Fiat-Shamir hashchain over a prime field (port of
libiop_tpu/bcs/poseidon.py, reference semantics of libiop's
bcs/hashing/{poseidon,algebraic_sponge}.tcc).

* permutation (poseidon.tcc:241-297): R_F/2 full rounds, R_P partial
  rounds, R_F/2 full rounds; each round adds its round-key row to the whole
  state before the S-box x^alpha; full rounds S-box every lane, partial
  rounds only the last lane; then the mix layer (a t x t MDS mat-vec, or
  the add-only near-MDS forms for t = 3, 4).
* sponge (algebraic_sponge.tcc:19-102): absorb adds rate-sized chunks into
  state[0:rate] with a permutation between chunks; squeeze permutes when
  the unread window is empty and reads state[0:rate].
* leaf hash = absorb + squeeze(1); a zk leaf appends its salt as one more
  element; two-to-one SETS state[0] = left, state[1] = right and squeezes
  (one permutation per tree node).

Parameters: the reference's alt_bn128_Fr presets (``poseidon_presets``,
a port-owned copy) for ``poseidon`` (alpha 5, 8 full + 56 partial rounds,
full MDS) and ``poseidon_high_alpha`` (alpha 17, near-MDS, 8 + 29); other
prime fields get constants from a pinned BLAKE2b stream and round counts
from the interpolation bound, as the JAX package derives them.

The host-int functions here serve the verifier and the hashchain; the
prover's leaves and Merkle levels run batched on the device through
kernel K9 (kernels/poseidon.py), whose plain twin ``BatchedPoseidon``
mirrors.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import poseidon as k9
from . import poseidon_presets as presets


def _stream(seed: bytes, p: int):
    """Deterministic field-element stream via BLAKE2b expansion (for fields
    with no reference preset)."""
    ctr = 0
    nbytes = (p.bit_length() + 7) // 8 + 16
    while True:
        out = hashlib.blake2b(seed + ctr.to_bytes(8, "little"),
                              digest_size=min(64, nbytes)).digest()
        ctr += 1
        yield int.from_bytes(out, "little") % p


def choose_alpha(p: int, minimum: int = 3) -> int:
    """Smallest odd alpha >= minimum with gcd(alpha, p-1) == 1: x^alpha
    permutes F_p only then."""
    a = minimum | 1
    while math.gcd(a, p - 1) != 1:
        a += 2
    return a


def derived_partial_rounds(alpha: int, state_size: int, security: int,
                           p_bits: int) -> int:
    """Interpolation-attack bound from the Poseidon paper:
    R_P >= ceil(log_alpha(2) * min(sec, p_bits/2)) + ceil(log_alpha(t))
    (56 for alpha 5, t 3, 128-bit security over BN254, the reference's
    table value)."""
    M = min(security, p_bits // 2)
    return (math.ceil(math.log(2) / math.log(alpha) * M)
            + math.ceil(math.log(state_size) / math.log(alpha)))


class PoseidonParams:
    """Permutation parameters: explicit (preset) or stream-derived."""

    def __init__(self, F, state_size: int = 3, rate: int = 2,
                 alpha: Optional[int] = None, full_rounds: int = 8,
                 partial_rounds: Optional[int] = None,
                 security_bits: int = 128,
                 near_mds: bool = False,
                 ark: Optional[List[List[int]]] = None,
                 mds: Optional[List[List[int]]] = None):
        assert rate < state_size
        self.F = F
        self.p = F.p
        self.state_size = state_size
        self.rate = rate
        self.capacity = state_size - rate
        if alpha is None:
            alpha = choose_alpha(self.p, 3)
        self.alpha = alpha
        assert math.gcd(alpha, self.p - 1) == 1, \
            f"x^{alpha} is not a permutation of {F.name}"
        self.full_rounds = full_rounds
        if partial_rounds is None:
            partial_rounds = derived_partial_rounds(
                alpha, state_size, security_bits, F.p.bit_length())
        self.partial_rounds = partial_rounds
        self.near_mds = near_mds
        total = full_rounds + partial_rounds
        if ark is not None:
            assert len(ark) == total, "ark matrix of wrong dimension"
            self.round_constants = [[v % self.p for v in row] for row in ark]
        else:
            gen = _stream(b"libiop-tpu/poseidon/rc/" + F.name.encode(), self.p)
            self.round_constants = [[next(gen) for _ in range(state_size)]
                                    for _ in range(total)]
        if mds is not None:
            self.mds = [[v % self.p for v in row] for row in mds]
        elif near_mds:
            assert state_size in (3, 4)
            self.mds = ([[1, 0, 1], [1, 1, 0], [0, 1, 1]] if state_size == 3
                        else [[0, 1, 1, 1], [1, 0, 1, 1],
                              [1, 1, 0, 1], [1, 1, 1, 0]])
        else:
            # Cauchy MDS matrix: M[i][j] = 1/(x_i + y_j) with distinct x, y
            xs = list(range(state_size))
            ys = list(range(state_size, 2 * state_size))
            self.mds = [[pow((xi + yj) % self.p, self.p - 2, self.p)
                         for yj in ys] for xi in xs]

    @classmethod
    def from_preset(cls, F, preset: dict) -> "PoseidonParams":
        assert F.p == presets.ALT_BN128_R, \
            "reference Poseidon presets are alt_bn128_Fr instantiations"
        return cls(F, state_size=preset["state_size"], rate=preset["rate"],
                   alpha=preset["alpha"], full_rounds=preset["full_rounds"],
                   partial_rounds=preset["partial_rounds"],
                   near_mds=preset["near_mds"],
                   ark=preset["ark"], mds=preset["mds"])

    @classmethod
    def for_field(cls, F, variant: str,
                  security_bits: int = 128) -> "PoseidonParams":
        """Reference presets for alt_bn128_Fr, stream-derived constants
        elsewhere (hash_enum.tcc:13-50)."""
        high = variant == "poseidon_high_alpha"
        if F.p == presets.ALT_BN128_R:
            return cls.from_preset(F, presets.ALTBN_HIGH_ALPHA_T3 if high
                                   else presets.ALTBN_DEFAULT_128)
        if high:
            return cls.high_alpha(F, security_bits)
        return cls(F, security_bits=security_bits)

    @classmethod
    def high_alpha(cls, F, security_bits: int = 128) -> "PoseidonParams":
        """High-alpha variant for fields without a preset: alpha 17,
        near-MDS mix, 8 full rounds, partial rounds from the bound."""
        return cls(F, state_size=3, rate=2, alpha=choose_alpha(F.p, 17),
                   full_rounds=8, partial_rounds=None,
                   security_bits=security_bits, near_mds=True)

    def _mix(self, s: List[int]) -> List[int]:
        p, t = self.p, self.state_size
        if self.near_mds and t == 3:
            return [(s[0] + s[2]) % p, (s[0] + s[1]) % p, (s[1] + s[2]) % p]
        if self.near_mds and t == 4:
            tot = sum(s) % p
            return [(tot - v) % p for v in s]
        return [sum(self.mds[i][j] * s[j] for j in range(t)) % p
                for i in range(t)]

    def permute(self, state: List[int]) -> List[int]:
        """The permutation on host ints (poseidon.tcc:241-297)."""
        p = self.p
        t = self.state_size
        s = [v % p for v in state]
        half = self.full_rounds // 2
        for r, rc in enumerate(self.round_constants):
            s = [(v + c) % p for v, c in zip(s, rc)]
            if half <= r < half + self.partial_rounds:
                s[t - 1] = pow(s[t - 1], self.alpha, p)  # last lane only
            else:
                s = [pow(v, self.alpha, p) for v in s]
            s = self._mix(s)
        return s


def salt_to_field_elem(salt: bytes, p: int) -> int:
    """Reference zk-salt parse (algebraic_sponge.tcc:109-126): 64-bit
    little-endian words placed big-endian-first into the bigint."""
    nw = len(salt) // 8
    val = 0
    for i in range(nw):
        val += int.from_bytes(salt[8 * i:8 * i + 8], "little") \
            << (64 * (nw - 1 - i))
    return val % p


class AlgebraicSponge:
    """Rate/capacity sponge, the reference's state machine
    (algebraic_sponge.tcc:19-102)."""

    def __init__(self, params: PoseidonParams):
        self.params = params
        self.reset()

    def reset(self):
        self.state = [0] * self.params.state_size
        self.next_unsqueezed = 0
        self.absorbing = False

    def absorb(self, values: Sequence[int]):
        p = self.params
        if self.absorbing:
            self.state = p.permute(self.state)
        vals = [int(v) % p.p for v in values]
        # rate-sized chunks; permute between chunks, not after the last
        for start in range(0, max(len(vals), 1), p.rate):
            if start > 0:
                self.state = p.permute(self.state)
            for i, v in enumerate(vals[start:start + p.rate]):
                self.state[i] = (self.state[i] + v) % p.p
        self.absorbing = True

    def squeeze(self, n: int) -> List[int]:
        p = self.params
        if self.absorbing:
            self.next_unsqueezed = 0
            self.absorbing = False
        out: List[int] = []
        while len(out) < n:
            if self.next_unsqueezed == 0:
                self.state = p.permute(self.state)
            while self.next_unsqueezed < p.rate and len(out) < n:
                out.append(self.state[self.next_unsqueezed])
                self.next_unsqueezed += 1
            if len(out) < n:
                self.next_unsqueezed = 0
        return out


def salts_to_elements(F, salts: bytes, num_leaves: int,
                      device) -> torch.Tensor:
    """A zk tree's salt blob (one elem_bytes salt per leaf) -> (L, 1, n)
    Montgomery elements, each salt read as int.from_bytes(salt, "little")
    mod p: the element the reference's leaf hash makes of the salt bytes
    that follow a leaf block (PoseidonHashing._bytes_to_elements)."""
    eb = F.elem_bytes
    assert len(salts) == num_leaves * eb, (len(salts), num_leaves, eb)
    limbs = np.frombuffer(salts, "<u2").reshape(num_leaves, F.L)
    canon = torch.from_numpy(np.ascontiguousarray(limbs.T).astype(np.int32))
    return F.from_canonical_limbs(canon.to(device)).unsqueeze(1)


class DeviceLeafColumns:
    """The leaves of a Poseidon tree kept on the device as (L, k, n)
    Montgomery elements (leaf j = column j; zk salts are not part of it);
    bytes reach the host only for the queried leaves."""

    __slots__ = ("F", "cols")

    def __init__(self, F, cols: torch.Tensor):
        self.F = F
        self.cols = cols

    def __len__(self) -> int:
        return self.cols.shape[2]

    def gather(self, positions) -> List[bytes]:
        F = self.F
        idx = torch.as_tensor(list(positions), dtype=torch.int64,
                              device=self.cols.device)
        rows = self.cols.index_select(2, idx).permute(0, 2, 1).contiguous()
        raw = F.canonical_to_bytes(F.to_canonical_limbs(rows))
        w = rows.shape[2] * F.elem_bytes
        return [raw[i * w:(i + 1) * w] for i in range(rows.shape[1])]


_CONSTS_KEYS = itertools.count(1)


class BatchedPoseidon:
    """The permutation over whole batches: states are (L, t, n) Montgomery
    limb tensors, one column per leaf or tree node.  ``permute``,
    ``hash_columns`` and ``two_to_one_columns`` are the plain torch
    functions (kernels/poseidon.py, the twin of K9).  The round constants
    and the MDS matrix are kept as the twin's tensors (per device) and as
    K9's 32-bit Montgomery words."""

    def __init__(self, params: PoseidonParams):
        self.params = params
        self.F = F = params.F
        self.t = params.state_size
        self.rate = params.rate
        self.alpha = params.alpha
        self.full_rounds = params.full_rounds
        self.partial_rounds = params.partial_rounds
        self.near_mds = params.near_mds
        self.rc_ints = params.round_constants
        self.mds_ints = None if params.near_mds else params.mds
        self.key = next(_CONSTS_KEYS)
        self._twin = {}  # the plain twin's constants, per device
        self._words = None

    def kernel_words(self):
        """The constants block K9 reads (csrc/poseidon.cu PoseidonConsts)."""
        if self._words is None:
            self._words = k9.pack_consts(self)
        return self._words

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """(L, t, n) -> (L, t, n)."""
        return k9.poseidon_permute_plain(self, state)

    def hash_columns(self, cols: torch.Tensor) -> torch.Tensor:
        """(L, k, n) elements, k per leaf -> (L, n) leaf digests."""
        return k9.poseidon_sponge_plain(self, cols)

    def two_to_one_columns(self, left: torch.Tensor,
                           right: torch.Tensor) -> torch.Tensor:
        """(L, n) left and right digests -> (L, n) parents: state[0..1] SET
        to (left, right) from zero, one permutation; the same as the sponge
        over the two elements (rate >= 2)."""
        return k9.poseidon_sponge_plain(self, torch.stack([left, right], 1))


class PoseidonHashing:
    """Bytes-interface hash suite (the peer of Blake2bHashing): digests are
    canonical little-endian field elements."""

    def __init__(self, F, security_bits: int = 128,
                 variant: str = "poseidon"):
        self.F = F
        self.params = PoseidonParams.for_field(F, variant, security_bits)
        self.name = variant
        self.security_bits = security_bits
        self.digest_bytes = F.elem_bytes
        self.salt_bytes = F.elem_bytes
        self._batched: Optional[BatchedPoseidon] = None

    @property
    def batched(self) -> BatchedPoseidon:
        if self._batched is None:
            self._batched = BatchedPoseidon(self.params)
        return self._batched

    def _bytes_to_elements(self, data: bytes) -> List[int]:
        eb = self.F.elem_bytes
        if len(data) % eb:
            data = data + b"\x00" * (eb - len(data) % eb)
        return [int.from_bytes(data[i:i + eb], "little") % self.F.p
                for i in range(0, len(data), eb)]

    def _elem_to_bytes(self, v: int) -> bytes:
        return int(v).to_bytes(self.F.elem_bytes, "little")

    def hash_elements(self, values: Sequence[int]) -> int:
        """Leaf hash over field elements (algebraic_sponge.tcc:224-231)."""
        sponge = AlgebraicSponge(self.params)
        sponge.absorb(values)
        return sponge.squeeze(1)[0]

    def leaf_hash(self, data: bytes) -> bytes:
        return self._elem_to_bytes(self.hash_elements(
            self._bytes_to_elements(data)))

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        """One permutation per node (algebraic_sponge.tcc:263-272)."""
        l_val = int.from_bytes(left, "little") % self.F.p
        r_val = int.from_bytes(right, "little") % self.F.p
        out = self.params.permute([l_val, r_val]
                                  + [0] * (self.params.state_size - 2))
        return self._elem_to_bytes(out[0])

    # -- batched on a device (kernel K9 on the card) ------------------------
    def _bytes_to_mont(self, blocks: Sequence[bytes], device) -> torch.Tensor:
        """Equal-length byte blocks, zero-padded to whole elements ->
        (L, k, n) Montgomery elements (each block's elements mod p)."""
        F = self.F
        eb = F.elem_bytes
        blen = -(-len(blocks[0]) // eb) * eb
        raw = b"".join(b + b"\x00" * (blen - len(b)) for b in blocks)
        arr = np.frombuffer(raw, dtype="<u2").reshape(len(blocks), -1, F.L)
        canon = torch.from_numpy(np.ascontiguousarray(
            arr.transpose(2, 1, 0)).astype(np.int32)).to(device)
        return F.from_canonical_limbs(canon)

    def _mont_to_bytes(self, digests: torch.Tensor) -> List[bytes]:
        F = self.F
        raw = F.canonical_to_bytes(F.to_canonical_limbs(digests))
        eb = F.elem_bytes
        return [raw[i * eb:(i + 1) * eb] for i in range(digests.shape[-1])]

    def heap_from_leaf_digests(self, leaf_digests: Sequence[bytes], device
                               ) -> torch.Tensor:
        """The (L, 2n) device heap over leaf digests given as bytes: every
        level through K9."""
        n = len(leaf_digests)
        heap = torch.zeros((self.F.L, 2 * n), dtype=torch.int32,
                           device=device)
        heap[:, n:] = self._bytes_to_mont(leaf_digests, device)[:, 0, :]
        return k9.poseidon_merkle_levels(self.batched, heap)

    def heap_digests(self, heap: torch.Tensor, ids: Sequence[int]
                     ) -> List[bytes]:
        """Host bytes of the nodes ``ids`` of a device heap (L, 2n) of
        Montgomery digests (BatchedPoseidon.merkle_heap)."""
        idx = torch.as_tensor(list(ids), dtype=torch.int64, device=heap.device)
        return self._mont_to_bytes(heap.index_select(1, idx))

    def device_leaf_digests(self, F, oracle_evals_list, domain,
                            coset_size: int, salts: Optional[bytes] = None):
        """Device tree of a (round, domain): each leaf's elements (for each
        oracle in ascending id order, its values at positions j + i*n,
        i < c) are read in coset order straight from the codewords, a zk
        leaf's salt joins as one more element, and K9 hashes the leaves and
        every Merkle level into a (L, 2n) heap.  The digests equal the
        reference's host hashes of the serialized leaf blocks.  Returns
        (root bytes, heap, DeviceLeafColumns)."""
        N = domain.num_elements()
        num_leaves = N // coset_size
        stacked = torch.stack(oracle_evals_list, dim=1)        # (L, O, N)
        cols = stacked.reshape(F.L, stacked.shape[1] * coset_size,
                               num_leaves)
        elems = cols
        if salts is not None:
            elems = torch.cat([cols, salts_to_elements(
                F, salts, num_leaves, cols.device)], dim=1)
        heap = k9.poseidon_merkle_heap(self.batched, elems)
        root = self.heap_digests(heap, [1])[0]
        return root, heap, DeviceLeafColumns(F, cols)

    def leaf_hash_batch(self, blocks: Sequence[bytes],
                        device="cuda") -> List[bytes]:
        """leaf_hash of every (equal-length) block, in one K9 launch."""
        assert len({len(b) for b in blocks}) == 1, "blocks of equal length"
        dev = resolve_device(device)
        cols = self._bytes_to_mont(blocks, dev)
        return self._mont_to_bytes(k9.poseidon_hash_columns(self.batched,
                                                            cols))

    def tree_layer(self, digests: Sequence[bytes],
                   device="cuda") -> List[bytes]:
        """two_to_one of each consecutive pair of digests, in one launch."""
        dev = resolve_device(device)
        pairs = self._bytes_to_mont(
            [digests[2 * i] + digests[2 * i + 1]
             for i in range(len(digests) // 2)], dev)
        return self._mont_to_bytes(k9.poseidon_hash_columns(self.batched,
                                                            pairs))


class PoseidonHashchain:
    """Fiat-Shamir hashchain over the algebraic sponge
    (algebraic_sponge.tcc:137-210; the method surface of
    Blake2bHashchain)."""

    def __init__(self, F, security_bits: int = 128,
                 variant: str = "poseidon"):
        self.F = F
        self.params = PoseidonParams.for_field(F, variant, security_bits)
        self.sponge = AlgebraicSponge(self.params)
        self.digest_bytes = F.elem_bytes

    @property
    def state(self) -> bytes:
        return b"".join(int(v).to_bytes(self.F.elem_bytes, "little")
                        for v in self.sponge.state)

    def absorb_bytes(self, data: bytes):
        eb = self.F.elem_bytes
        vals = [int.from_bytes(data[i:i + eb], "little") % self.F.p
                for i in range(0, len(data), eb)]
        self.sponge.absorb(vals or [0])

    def absorb_root(self, root: bytes):
        self.sponge.absorb([int.from_bytes(root, "little") % self.F.p])

    def absorb_field_elements(self, values: Sequence[int]):
        self.sponge.absorb([0] + [int(v) % self.F.p for v in values])

    def squeeze_field_elements(self, n: int) -> List[int]:
        return self.sponge.squeeze(n)

    def squeeze_query_positions(self, n: int, domain_size: int) -> List[int]:
        """Least-significant 64-bit word of each squeezed element, reduced
        mod the range (algebraic_sponge.tcc:188-205)."""
        mask = (1 << 64) - 1
        return [(v & mask) % domain_size for v in self.sponge.squeeze(n)]
