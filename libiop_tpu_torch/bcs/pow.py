"""Fiat-Shamir proof-of-work grinding (port of libiop_tpu/bcs/pow.py): after
the final round the prover finds the smallest nonce whose hash with the
hashchain state clears ``work_bits`` leading zero bits.  BLAKE2b for every
hash suite; the native solver takes challenges of up to 64 bytes (a BLAKE2b
hashchain state), and a longer one (a Poseidon sponge state of t elements)
is ground by the Python loop, as the reference does."""
from __future__ import annotations

from .hashing import blake2b


class PowParameters:
    def __init__(self, work_bits: int = 0):
        assert 0 <= work_bits < 60
        self.work_bits = work_bits

    def _ok(self, challenge: bytes, nonce: int) -> bool:
        h = blake2b(b"pow" + challenge + nonce.to_bytes(8, "little"), 8)
        return int.from_bytes(h, "little") < (1 << (64 - self.work_bits))

    def solve(self, challenge: bytes) -> int:
        if self.work_bits == 0:
            return 0
        from .native_blake2b import MAX_CHALLENGE, pow_solve
        if len(challenge) <= MAX_CHALLENGE:
            return pow_solve(challenge, self.work_bits)
        nonce = 0
        while not self._ok(challenge, nonce):
            nonce += 1
        return nonce

    def verify(self, challenge: bytes, nonce: int) -> bool:
        return self.work_bits == 0 or self._ok(challenge, nonce)
