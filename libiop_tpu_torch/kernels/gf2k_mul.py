"""K16: GF(2^k) product / square / inverse wrapper (csrc/gf2k_mul.cu) and
its plain twins.

The twins work on int64 copies of the 32-bit words (torch's CPU int32 right
shift is arithmetic, and CPU uint32 lacks shifts): the product is a 4-bit
window comb (a table of the 16 multiples of b by a nibble, one gathered row
per nibble of a, Horner in x^4), the square interleaves zeros, and both
fold the 2W-word result through the pentanomial's taps in two passes as
the reference does (libiop_tpu/fields/binary.py:200-221); the inverse is the
reference's Itoh-Tsujii chain over them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import (LAUNCHES, binary_words, broadcast_operand, build, check_limbs,
               ptr, raise_on_error, stream_ptr)

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5 \
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

MUL, SQUARE, INV = 0, 1, 2
M32 = 0xFFFFFFFF


def words64(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their unsigned values."""
    return t.to(torch.int64) & M32


def words32(t: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit values -> the int32 words with those bits."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def reduce64(F, t: torch.Tensor) -> torch.Tensor:
    """(2W, n) carry-less product -> (W, n) mod the pentanomial: fold the
    high words through each tap, then the bits that spilled past word W-1."""
    W = F.W
    hi = t[W:]
    lo = torch.cat([t[:W], torch.zeros_like(t[:1])])
    for s in F.taps:
        lo[:W] ^= (hi << s) & M32
        if s:
            lo[1:] ^= hi >> (32 - s)
    top = lo[W]
    for s in F.taps:
        lo[0] ^= top << s
    return lo[:W]


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """Multiply a word vector (rows, n) by x^s, 0 < s < 32, keeping its rows."""
    out = (x << s) & M32
    out[1:] |= x[:-1] >> (32 - s)
    return out


def clmul64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(W, n) x (W, n) int64 words -> (2W, n) carry-less product."""
    W, n = a.shape
    table = torch.zeros((16, W + 1, n), dtype=torch.int64, device=a.device)
    table[1, :W] = b
    for s in (1, 2, 3):
        table[1 << s] = _shift_left(table[1], s)
    for u in range(3, 16):
        if u & (u - 1):
            table[u] = table[u & (u - 1)] ^ table[u & -u]
    acc = torch.zeros((2 * W, n), dtype=torch.int64, device=a.device)
    for j in range(7, -1, -1):
        u = (a >> (4 * j)) & 15
        rows = table.gather(0, u[:, None, :].expand(W, W + 1, n))
        for i in range(W):
            acc[i:i + W + 1] ^= rows[i]
        if j:
            acc = _shift_left(acc, 4)
    return acc


def _spread16(x: torch.Tensor) -> torch.Tensor:
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def mul64(F, a, b):
    return reduce64(F, clmul64(a, b))


def square64(F, a):
    t = torch.stack([_spread16(a), _spread16(a >> 16)], dim=1)
    return reduce64(F, t.reshape(2 * F.W, -1))


def inv64(F, a):
    """a^(2^k - 2) by the Itoh-Tsujii chain (0 for a = 0)."""
    m = F.k - 1
    res, e = a, 1
    for bit in bin(m)[3:]:
        t = res
        for _ in range(e):
            t = square64(F, t)
        res = mul64(F, t, res)
        e *= 2
        if bit == "1":
            res = mul64(F, square64(F, res), a)
            e += 1
    return square64(F, res)


def _flat(F, t, batch):
    """(W, *batch_t) broadcast to (W, *batch), flattened to int64 words."""
    t = t.reshape((F.W,) + (1,) * (len(batch) - (t.ndim - 1)) + t.shape[1:])
    return words64(t.expand((F.W,) + tuple(batch)).reshape(F.W, -1))


def gf2k_mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    out = mul64(F, _flat(F, a, batch), _flat(F, b, batch))
    return words32(out).reshape((F.W,) + batch)


def gf2k_square_plain(F, a: torch.Tensor) -> torch.Tensor:
    return words32(square64(F, _flat(F, a, a.shape[1:]))).reshape(a.shape)


def gf2k_inv_plain(F, a: torch.Tensor) -> torch.Tensor:
    return words32(inv64(F, _flat(F, a, a.shape[1:]))).reshape(a.shape)


def _check(F, name, t, device=None):
    check_limbs(name, t, device)
    if t.shape[0] != F.W:
        raise ValueError(f"{name}: expected {F.W} words, got {t.shape[0]}")


def _launch(F, op, out, a, b, n, maps):
    fn = build.launcher("gf2k_mul", "gf2k_mul_launch", _ARGTYPES)
    err = fn(op, ptr(out), ptr(a), ptr(b), n, *maps, binary_words(F),
             F.kernel_params(), stream_ptr(a.device))
    raise_on_error("gf2k_mul", err)
    LAUNCHES["gf2k_mul"] += 1


def gf2k_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for int32 word tensors (W, *batch_a), (W, *batch_b) that
    broadcast over the batch.  CUDA tensors launch K16; CPU tensors run the
    plain twin."""
    _check(F, "gf2k_mul(a)", a)
    _check(F, "gf2k_mul(b)", b, a.device)
    if a.device.type == "cpu":
        return gf2k_mul_plain(F, a, b)
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    n = math.prod(batch)
    out = torch.empty((F.W,) + batch, dtype=torch.int32, device=a.device)
    a, (a_div, a_mod) = broadcast_operand(a, batch)
    b, (b_div, b_mod) = broadcast_operand(b, batch)
    _launch(F, MUL, out, a, b, n, (a_div, a_mod, b_div, b_mod))
    return out


def _unary(F, op, name, plain, a):
    _check(F, f"{name}(a)", a)
    if a.device.type == "cpu":
        return plain(F, a)
    out = torch.empty_like(a)
    _launch(F, op, out, a, a, a[0].numel(), (1, 1, 1, 1))
    return out


def gf2k_square(F, a: torch.Tensor) -> torch.Tensor:
    """a^2 elementwise (K16 on the card)."""
    return _unary(F, SQUARE, "gf2k_square", gf2k_square_plain, a)


def gf2k_inv(F, a: torch.Tensor) -> torch.Tensor:
    """a^-1 elementwise, 0 for 0 (K16 on the card: the whole Itoh-Tsujii
    chain in one launch)."""
    return _unary(F, INV, "gf2k_inv", gf2k_inv_plain, a)
