"""Binary extension fields GF(2^k), k in {64, 128, 192, 256}, in PyTorch.

Port of libiop_tpu/fields/binary.py with its reduction pentanomials:
    gf64 : x^64  + x^4  + x^3 + x + 1
    gf128: x^128 + x^7  + x^2 + x + 1
    gf192: x^192 + x^7  + x^2 + x + 1
    gf256: x^256 + x^10 + x^5 + x^2 + 1

A batch of elements is a ``torch.int32`` tensor of shape ``(W, *batch)``
(W = k/32, bit j of word i = coefficient of x^(32i+j)): the reference's
uint32 words reinterpreted, so ``interop.limbs_from_numpy`` carries them
unchanged.  The bit representation is canonical (no Montgomery form).

Addition is XOR (``kind = "additive"``).  On the card the product, the
square and the inverse run through kernel K16 (kernels/gf2k_mul.py); CPU
tensors run its plain twins.  Host-int methods give the reference's values
and its exact ``rng.bytes`` draws (``random_ints``), with a windowed
carry-less product and an extended-Euclid inverse in place of its
bit-serial loops (same results, far fewer Python steps).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ..kernels.gf2k_mul import gf2k_inv, gf2k_mul, gf2k_square


def clmul_ints(a: int, b: int) -> int:
    """Carry-less product of two non-negative ints, 4 bits of b a step."""
    if a.bit_length() < b.bit_length():
        a, b = b, a
    t2, t4, t8 = a << 1, a << 2, a << 3
    table = [0, a, t2, t2 ^ a, t4, t4 ^ a, t4 ^ t2, t4 ^ t2 ^ a,
             t8, t8 ^ a, t8 ^ t2, t8 ^ t2 ^ a, t8 ^ t4, t8 ^ t4 ^ a,
             t8 ^ t4 ^ t2, t8 ^ t4 ^ t2 ^ a]
    r = 0
    s = (b.bit_length() + 3) & ~3
    while s:
        s -= 4
        r = (r << 4) ^ table[(b >> s) & 15]
    return r


def xor_reduce(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """XOR-reduce ``t`` over ``dim`` (the sum in characteristic 2) by a
    log-depth tree of halvings; the dimension is removed."""
    t = t.movedim(dim, -1)
    while t.shape[-1] > 1:
        n = t.shape[-1]
        if n & 1:
            t = torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)
            n += 1
        t = torch.bitwise_xor(t[..., : n // 2], t[..., n // 2:])
    if t.shape[-1] == 0:
        return t.new_zeros(t.shape[:-1])
    return t[..., 0]


def subset_sums(basis: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """All 2^len(basis) XOR subset sums in subset-sum order (the
    reference's ``subset_sums_ints``), by doubling: (W, m) basis and (W,)
    shift -> (W, 2^m)."""
    out = shift.reshape(-1, 1)
    for j in range(basis.shape[1]):
        out = torch.cat([out, torch.bitwise_xor(out, basis[:, j:j + 1])],
                        dim=1)
    return out.contiguous()


class BinaryField:
    """GF(2^k) with batched word arithmetic on torch tensors (any device)."""

    kind = "additive"

    def __init__(self, k: int, taps: Sequence[int], name: str):
        assert k % 32 == 0
        self.k = k
        self.bits = k
        self.W = k // 32
        #: rows of the (L, *batch) layout, the name the protocols use
        self.L = self.W
        self.taps = tuple(sorted(taps))
        assert max(self.taps) < 32 and len(self.taps) == 4
        self.name = name
        self.elem_bytes = k // 8
        self.extension_degree = k
        self.modulus_int = (1 << k) | sum(1 << t for t in self.taps)
        self._mask = (1 << k) - 1
        self._kernel_taps = (ctypes.c_uint32 * 4)(*self.taps)

    def kernel_params(self):
        """The reduction taps as the CUDA kernels take them."""
        return self._kernel_taps

    # -- host conversions ---------------------------------------------------
    def from_ints_np(self, xs, shape=None) -> np.ndarray:
        """Canonical ints -> (W, *shape) numpy uint32 words."""
        arr = np.asarray(xs, dtype=object)
        if shape is None:
            shape = arr.shape
        flat = arr.reshape(-1)
        eb = self.elem_bytes
        raw = b"".join(int(v).to_bytes(eb, "little") for v in flat)
        out = np.frombuffer(raw, dtype="<u4").reshape(flat.size, self.W)
        return out.T.astype(np.uint32).reshape((self.W,) + tuple(shape))

    def from_ints(self, xs, device, shape=None) -> torch.Tensor:
        """Canonical ints -> (W, *shape) int32 tensor on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(
            self.from_ints_np(xs, shape).view(np.int32))).to(device)

    def scalar(self, value: int, like: torch.Tensor) -> torch.Tensor:
        """One element as (W, 1, ..., 1), broadcastable against ``like``."""
        return self.from_ints([self.sample_int(value)], like.device).reshape(
            (self.W,) + (1,) * (like.ndim - 1))

    def canonical_to_bytes(self, canonical) -> bytes:
        """(W, N) words -> N little-endian elements of elem_bytes each."""
        if isinstance(canonical, torch.Tensor):
            canonical = canonical.cpu().numpy()
        arr = np.asarray(canonical).astype(np.uint32).reshape(self.W, -1)
        return np.ascontiguousarray(arr.T).astype("<u4").tobytes()

    def to_ints(self, words) -> np.ndarray:
        """(W, *batch) words -> canonical ints (object ndarray)."""
        shape = tuple(words.shape[1:])
        raw = self.canonical_to_bytes(words)
        eb = self.elem_bytes
        n = len(raw) // eb
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = int.from_bytes(raw[i * eb:(i + 1) * eb], "little")
        return out.reshape(shape)

    def to_int(self, words) -> int:
        """The first element of a word tensor as a canonical int."""
        return int(self.to_ints(words).reshape(-1)[0])

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros((self.W,) + tuple(shape), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        out = self.zeros(shape, device)
        out[0] = 1
        return out

    def random_ints(self, n: int, rng: np.random.Generator | None = None):
        """n uniform elements as Python ints (exact k-bit draws)."""
        rng = rng or np.random.default_rng()
        eb = self.elem_bytes
        raw = rng.bytes(n * eb)
        return [int.from_bytes(raw[i * eb:(i + 1) * eb], "little")
                for i in range(n)]

    def random(self, shape, rng, device) -> torch.Tensor:
        n = int(np.prod(shape)) if shape else 1
        vals = self.random_ints(n, rng)
        return self.from_ints(np.array(vals, dtype=object).reshape(shape or ()),
                              device)

    # -- host-int arithmetic (verifier side) ---------------------------------
    @property
    def field_size(self) -> int:
        return 1 << self.k

    def add_ints(self, a: int, b: int) -> int:
        return a ^ b

    def sub_ints(self, a: int, b: int) -> int:
        return a ^ b

    def neg_int(self, a: int) -> int:
        return a

    def sample_int(self, x: int) -> int:
        return x & self._mask

    def _reduce_int(self, x: int) -> int:
        k, mask, taps = self.k, self._mask, self.taps
        while x >> k:
            hi = x >> k
            x &= mask
            for t in taps:
                x ^= hi << t
        return x

    def mul_ints(self, a: int, b: int) -> int:
        return self._reduce_int(clmul_ints(a, b))

    def pow_int(self, a: int, e: int) -> int:
        result, base = 1, a
        while e:
            if e & 1:
                result = self.mul_ints(result, base)
            base = self.mul_ints(base, base)
            e >>= 1
        return result

    def inv_int(self, a: int) -> int:
        """a^-1 by the extended Euclidean algorithm over GF(2)[x] (the
        reference's a^(2^k - 2), the same element)."""
        assert a != 0
        u, v, g1, g2 = self._reduce_int(a), self.modulus_int, 1, 0
        while u != 1:
            j = u.bit_length() - v.bit_length()
            if j < 0:
                u, v, g1, g2, j = v, u, g2, g1, -j
            u ^= v << j
            g1 ^= g2 << j
        return self._reduce_int(g1)

    # -- ring ops (device) ----------------------------------------------------
    def add(self, a, b):
        return torch.bitwise_xor(a, b)

    sub = add

    def neg(self, a):
        return a

    def mul(self, a, b):
        """Carry-less product reduced mod the pentanomial (K16 on the card)."""
        return gf2k_mul(self, a.contiguous(), b.contiguous())

    def square(self, a):
        return gf2k_square(self, a.contiguous())

    def mul_scalar(self, a, s):
        return self.mul(a, s.reshape((self.W,) + (1,) * (a.ndim - 1)))

    def inv(self, a):
        """Itoh-Tsujii inversion, inv(0) = 0 (K16 on the card)."""
        return gf2k_inv(self, a.contiguous())

    def batch_inverse_and_mul(self, a, c):
        """inv(a) * c elementwise: a K16 inverse, then a K16 product."""
        return self.mul(self.inv(a), c)

    def pow_static(self, a, e: int):
        """a^e for a static e >= 0 (square and multiply, MSB first)."""
        acc = self.ones(a.shape[1:], a.device)
        for bit in bin(e)[2:] if e else "":
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    # -- predicates / serialization -------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, pred, a, b):
        return torch.where(pred[None, ...], a, b)

    def to_canonical_limbs(self, a):
        return a

    def from_canonical_limbs(self, a):
        return a


@functools.lru_cache(maxsize=None)
def gf64() -> BinaryField:
    return BinaryField(64, (4, 3, 1, 0), "gf64")


@functools.lru_cache(maxsize=None)
def gf128() -> BinaryField:
    return BinaryField(128, (7, 2, 1, 0), "gf128")


@functools.lru_cache(maxsize=None)
def gf192() -> BinaryField:
    return BinaryField(192, (7, 2, 1, 0), "gf192")


@functools.lru_cache(maxsize=None)
def gf256() -> BinaryField:
    return BinaryField(256, (10, 5, 2, 0), "gf256")
