"""Prime-field arithmetic in PyTorch: limb-decomposed Montgomery form.

Port of libiop_tpu/fields/prime.py (multiplicative fields only): edwards_Fr
(12 limbs, R = 2^192) and alt_bn128_Fr (16 limbs, R = 2^256).  A batch of
field elements is a ``torch.int32`` tensor of shape ``(L, *batch)``, limbs
first, each entry one 16-bit limb: the reference's values and layout, so the
two packages compare limb for limb.  Values are in Montgomery form
(x*R mod p, R = 2^(16L)) and always fully reduced (< p).

On the card the product runs through kernel K1 (kernels/mont_mul.py),
add/sub/neg through K5 (kernels/field_addsub.py), the lazy-sum
reductions through K6 (kernels/lazy_reduce.py) and the batched inverse
through K20 (kernels/batch_inv.py); CPU tensors run their plain twins
(fields/limbs.py).  Host-int methods mirror the reference exactly,
including the ``rng.bytes`` draws of ``random_ints`` that example
generation and transcripts depend on.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels.batch_inv import batch_inv
from ..kernels.field_addsub import field_addsub
from ..kernels.lazy_reduce import lazy_reduce
from ..kernels.mont_mul import mont_mul
from . import limbs as _limbs

LIMB_BITS = _limbs.LIMB_BITS
LIMB_MASK = _limbs.LIMB_MASK


def _int_to_limbs(x: int, L: int) -> np.ndarray:
    assert x >> (LIMB_BITS * L) == 0, "value does not fit in L limbs"
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)],
                    dtype=np.uint32)


class PrimeField:
    """F_p with batched limb arithmetic on torch tensors (any device)."""

    kind = "multiplicative"

    def __init__(self, p: int, name: str, generator: int, two_adicity: int):
        self.p = p
        self.name = name
        self.L = -(-p.bit_length() // LIMB_BITS)
        L = self.L
        self.R = (1 << (LIMB_BITS * L)) % p
        self.R2 = (self.R * self.R) % p
        self.pinv16 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.p_limbs = _int_to_limbs(p, L)
        self.two_adicity = two_adicity
        self.multiplicative_generator = generator
        self.root_of_unity = pow(generator, (p - 1) >> two_adicity, p)
        self.elem_bytes = 2 * L
        # kernel parameters: p as 32-bit limbs and n0 = -p^-1 mod 2^32 (the
        # 32-bit CIOS constant, derived from p; not the 16-bit pinv16)
        assert L % 2 == 0, "the CUDA kernels pair 16-bit limbs into 32 bits"
        p32 = [(p >> (32 * j)) & 0xffffffff for j in range(L // 2)]
        n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self._kernel_params = (ctypes.c_uint32 * (L // 2 + 1))(*p32, n0)
        self._dev_consts = {}

    # ------------------------------------------------------------------
    # constants
    # ------------------------------------------------------------------
    def kernel_params(self):
        return self._kernel_params

    def p_limbs_tensor(self, device, dtype=torch.int32) -> torch.Tensor:
        key = ("p", str(device), dtype)
        t = self._dev_consts.get(key)
        if t is None:
            t = self._dev_consts[key] = torch.tensor(
                self.p_limbs.astype(np.int64), dtype=dtype, device=device)
        return t

    def _limb_const(self, tag: str, value: int, device, ndim: int):
        key = (tag, str(device))
        t = self._dev_consts.get(key)
        if t is None:
            t = self._dev_consts[key] = torch.tensor(
                _int_to_limbs(value, self.L).astype(np.int32), device=device)
        return t.reshape((self.L,) + (1,) * (ndim - 1))

    # ------------------------------------------------------------------
    # host-side conversions
    # ------------------------------------------------------------------
    def from_ints_np(self, xs, shape=None) -> np.ndarray:
        """Canonical ints -> Montgomery limb array (L, *shape), numpy uint32."""
        arr = np.asarray(xs, dtype=object)
        if shape is None:
            shape = arr.shape
        flat = arr.reshape(-1)
        eb = self.elem_bytes
        buf = bytearray(flat.size * eb)
        p, R = self.p, self.R
        for k, v in enumerate(flat):
            buf[k * eb:(k + 1) * eb] = (int(v) * R % p).to_bytes(eb, "little")
        out = np.frombuffer(bytes(buf), dtype="<u2").reshape(flat.size, self.L)
        return out.T.astype(np.uint32).reshape((self.L,) + tuple(shape))

    def from_ints(self, xs, device, shape=None) -> torch.Tensor:
        """Canonical ints -> Montgomery limb tensor (L, *shape) on device."""
        return torch.from_numpy(np.ascontiguousarray(
            self.from_ints_np(xs, shape), dtype=np.int32)).to(device)

    def scalar(self, value: int, like: torch.Tensor) -> torch.Tensor:
        """One element as (L, 1, ..., 1), broadcastable against ``like``."""
        return self.from_ints([value % self.p], like.device).reshape(
            (self.L,) + (1,) * (like.ndim - 1))

    def canonical_to_bytes(self, canonical: torch.Tensor) -> bytes:
        """Canonical limb tensor (L, N) -> little-endian bytes, elementwise
        contiguous (elem_bytes per element, elements in batch order)."""
        arr = canonical.reshape(self.L, -1).cpu().numpy().astype(np.uint16)
        return arr.T.astype("<u2").tobytes()

    def to_ints(self, limbs: torch.Tensor) -> np.ndarray:
        """Montgomery limb tensor -> canonical ints (object ndarray)."""
        batch_shape = tuple(limbs.shape[1:])
        raw = self.canonical_to_bytes(self.to_canonical_limbs(limbs))
        eb = self.elem_bytes
        n = len(raw) // eb
        out = np.empty(n, dtype=object)
        for k in range(n):
            out[k] = int.from_bytes(raw[k * eb:(k + 1) * eb], "little")
        return out.reshape(batch_shape)

    def to_int(self, limbs: torch.Tensor) -> int:
        """The first element of a limb tensor as a canonical int."""
        return int(self.to_ints(limbs).reshape(-1)[0])

    # -- host-int arithmetic (verifier side) -------------------------------
    @property
    def field_size(self) -> int:
        return self.p

    def add_ints(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub_ints(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg_int(self, a: int) -> int:
        return (-a) % self.p

    def mul_ints(self, a: int, b: int) -> int:
        return a * b % self.p

    def pow_int(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv_int(self, a: int) -> int:
        return pow(a, self.p - 2, self.p)

    def sample_int(self, x: int) -> int:
        return x % self.p

    def random_ints(self, n: int, rng: np.random.Generator | None = None):
        """n field elements as Python ints, each from elem_bytes + 16 bytes
        of ``rng.bytes`` (the reference's exact draws)."""
        rng = rng or np.random.default_rng()
        nbytes = self.elem_bytes + 16
        raw = rng.bytes(n * nbytes)
        return [int.from_bytes(raw[k * nbytes:(k + 1) * nbytes], "little")
                % self.p for k in range(n)]

    def random(self, shape, rng, device) -> torch.Tensor:
        n = int(np.prod(shape)) if shape else 1
        ints = self.random_ints(n, rng)
        return self.from_ints(np.array(ints, dtype=object).reshape(shape or ()),
                              device)

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros((self.L,) + tuple(shape), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        one = self._limb_const("one", self.R, device, len(tuple(shape)) + 1)
        return one.expand((self.L,) + tuple(shape)).contiguous()

    # ------------------------------------------------------------------
    # ring ops
    # ------------------------------------------------------------------
    def add(self, a, b):
        """(a + b) mod p (kernel K5 on the card)."""
        return field_addsub(self, "add", a.contiguous(), b.contiguous())

    def sub(self, a, b):
        """(a - b) mod p (kernel K5 on the card)."""
        return field_addsub(self, "sub", a.contiguous(), b.contiguous())

    def neg(self, a):
        """(-a) mod p (kernel K5 on the card)."""
        return field_addsub(self, "neg", a.contiguous())

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (kernel K1 on the card)."""
        return mont_mul(self, a.contiguous(), b.contiguous())

    def square(self, a):
        return self.mul(a, a)

    def mul_scalar(self, a, s):
        return self.mul(a, s.reshape((self.L,) + (1,) * (a.ndim - 1)))

    def mont_reduce_wide(self, t):
        """Montgomery-reduce a lazy limb accumulator t (K <= 2L+2 rows,
        columns summed without carries) to canonical L limbs of
        value(t) * R^-1 mod p (kernel K6 on the card)."""
        return lazy_reduce(self, t.to(torch.int64).contiguous(), False)

    def lazy_sum_reduce(self, t):
        """Reduce a lazy limb-wise sum of Montgomery values back to the
        Montgomery form of the sum, value(t) mod p (kernel K6 on the card)."""
        return lazy_reduce(self, t.to(torch.int64).contiguous(), True)

    def segment_reduce(self, prod, seg_ids, num_segments: int):
        """Segment-sum of field values: prod (L, nnz) -> (L, num_segments)."""
        lazy = torch.zeros((self.L, num_segments), dtype=torch.int64,
                           device=prod.device)
        lazy.index_add_(1, seg_ids, prod.to(torch.int64))
        return self.lazy_sum_reduce(lazy)

    # ------------------------------------------------------------------
    # exponentiation / inversion
    # ------------------------------------------------------------------
    def pow_static(self, a, e: int):
        """a^e for a static exponent e >= 0 (square and multiply, MSB first)."""
        acc = self.ones(a.shape[1:], a.device)
        for bit in bin(e)[2:] if e else "":
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inversion, a^(p-2) with inv(0) = 0 (kernel K20 on the
        card: Montgomery's trick per block)."""
        return batch_inv(self, a.contiguous())

    def batch_inverse_and_mul(self, a, c):
        """inv(a) * c elementwise, the product fused into K20."""
        return batch_inv(self, a.contiguous(), c.contiguous())

    # ------------------------------------------------------------------
    # predicates / conversions
    # ------------------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, pred, a, b):
        """pred (*batch,) bool; a, b (L, *batch)."""
        return torch.where(pred[None, ...], a, b)

    def to_canonical_limbs(self, a):
        """Montgomery -> canonical-value limbs: a * R^-1 mod p."""
        return self.mul(a, self._limb_const("canon_one", 1, a.device, a.ndim))

    def r2_limbs(self, device, ndim: int):
        """R^2 mod p as (L, 1, ..., 1): multiplying by it enters Montgomery form."""
        return self._limb_const("R2", self.R2, device, ndim)

    def from_canonical_limbs(self, a):
        return self.mul(a, self.r2_limbs(a.device, a.ndim))


@functools.lru_cache(maxsize=None)
def edwards_fr() -> PrimeField:
    """181-bit scalar field of the libff 'edwards' curve; 2-adicity 31."""
    p = 1552511030102430251236801561344621993261920897571225601
    return PrimeField(p, "edwards_Fr", generator=19, two_adicity=31)


@functools.lru_cache(maxsize=None)
def alt_bn128_fr() -> PrimeField:
    """254-bit scalar field of alt_bn128 (BN254); 2-adicity 28."""
    p = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    return PrimeField(p, "alt_bn128_Fr", generator=5, two_adicity=28)
