"""K10: blocked Horner wrapper (csrc/horner.cu) and its plain twins, over
a prime field (Montgomery limbs) or GF(2^k) (words)."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.binary import xor_reduce
from ..fields.limbs import add_plain, mul_plain
from .gf2k_mul import gf2k_mul_plain, gf2k_square_plain

#: degree above which evaluation uses the blocked sqrt(d) decomposition
#: (the reference's _HORNER_BLOCK_THRESHOLD)
BLOCK_THRESHOLD = 256

_CHUNKS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def blocking(d: int):
    """(m, S): chunk length and chunk count of the reference's split."""
    if d <= BLOCK_THRESHOLD:
        return max(d, 1), 1
    m = 1 << ((d - 1).bit_length() + 1) // 2
    return m, -(-d // m)


def horner_plain(F, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's evaluation: S chunks of m coefficients evaluated
    together by one m-step Horner, then an S-step Horner in x^m."""
    d = coeffs.shape[1]
    k = x.shape[1]
    m, S = blocking(d)
    if S * m != d:
        coeffs = torch.cat([coeffs, coeffs.new_zeros((F.L, S * m - d))], 1)
    chunks = coeffs.reshape(F.L, S, m)
    xb = x[:, None, :]
    acc = torch.zeros((F.L, S, k), dtype=torch.int32, device=x.device)
    for j in range(m - 1, -1, -1):
        acc = add_plain(F, mul_plain(F, acc, xb), chunks[:, :, j:j + 1])
    if S == 1:
        return acc[:, 0]
    xm = x
    e = m
    while e > 1:
        xm = mul_plain(F, xm, xm)
        e >>= 1
    total = torch.zeros((F.L, k), dtype=torch.int32, device=x.device)
    for s in range(S - 1, -1, -1):
        total = add_plain(F, mul_plain(F, total, xm), acc[:, s])
    return total


#: elements (chunks x chunk length x points) one step of the GF(2^k) twin
#: forms at once
_GF2_BLOCK = 1 << 22


def _power_table_gf2(F, x: torch.Tensor, n: int) -> torch.Tensor:
    """(W, n, k) powers x^0..x^(n-1) of points x (W, k), by doubling."""
    out = torch.zeros((F.W, 1, x.shape[1]), dtype=torch.int32,
                      device=x.device)
    out[0] = 1
    s = x[:, None, :]
    while out.shape[1] < n:
        out = torch.cat([out, gf2k_mul_plain(F, out, s)], dim=1)
        s = gf2k_square_plain(F, s)
    return out[:, :n]


def horner_gf2_plain(F, coeffs: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
    """sum_i c_i x^i at points x (W, k) over GF(2^k): chunk values
    q_s(x) = sum_j c_{s m + j} x^j from the power table x^j, then
    sum_s q_s(x) (x^m)^s, each a product and an XOR reduction (the split
    of the reference's horner_eval, m ~ sqrt(d))."""
    d, k = coeffs.shape[1], x.shape[1]
    m = 1 << ((max(d, 1) - 1).bit_length() + 1) // 2
    S = -(-d // m)
    if S * m != d:
        coeffs = torch.cat([coeffs, coeffs.new_zeros((F.W, S * m - d))], 1)
    chunks = coeffs.reshape(F.W, S, m, 1)
    pw = _power_table_gf2(F, x, m)
    step = max(1, _GF2_BLOCK // (S * m))
    q = torch.cat([xor_reduce(gf2k_mul_plain(F, chunks,
                                             pw[:, None, :, a:a + step]),
                              dim=2) for a in range(0, k, step)], dim=2)
    xm = gf2k_mul_plain(F, pw[:, -1], x)
    return xor_reduce(gf2k_mul_plain(F, q, _power_table_gf2(F, xm, S)),
                      dim=1)


def horner(F, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Values (L, k) of the polynomial coeffs (L, d) at the points x (L, k),
    over a prime field or GF(2^k).  CUDA tensors launch K10 (its GF(2^k)
    instantiation for a binary field; once for d <= 256, else twice: the
    chunk scan and the combine); CPU tensors run the plain twin."""
    check_limbs("horner(coeffs)", coeffs)
    check_limbs("horner(x)", x, coeffs.device)
    if coeffs.ndim != 2 or x.ndim != 2 or coeffs.shape[0] != F.L \
            or x.shape[0] != F.L:
        raise ValueError(f"horner: bad shapes coeffs={tuple(coeffs.shape)} "
                         f"x={tuple(x.shape)}")
    binary = F.kind == "additive"
    if coeffs.device.type == "cpu":
        return (horner_gf2_plain if binary else horner_plain)(F, coeffs, x)
    d, k = coeffs.shape[1], x.shape[1]
    m, S = blocking(d)
    dev = coeffs.device
    out = torch.empty((F.L, k), dtype=torch.int32, device=dev)
    acc = out if S == 1 else torch.empty((F.L, S * k), dtype=torch.int32,
                                         device=dev)
    suffix, words, counter = ("_gf2", binary_words(F), "horner_gf2") \
        if binary else ("", field_words(F), "horner")
    fn = build.launcher("horner", f"horner_chunks{suffix}_launch",
                        _CHUNKS_ARGTYPES)
    err = fn(ptr(acc), ptr(coeffs), ptr(x), d, m, S, k, words,
             F.kernel_params(), stream_ptr(dev))
    raise_on_error("horner", err)
    LAUNCHES[counter] += 1
    if S > 1:
        fn = build.launcher("horner", f"horner_combine{suffix}_launch",
                            _COMBINE_ARGTYPES)
        err = fn(ptr(out), ptr(acc), ptr(x), m, S, k, words,
                 F.kernel_params(), stream_ptr(dev))
        raise_on_error("horner", err)
        LAUNCHES[counter] += 1
    return out
