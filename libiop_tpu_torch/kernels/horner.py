"""K10: blocked Horner wrapper (csrc/horner.cu) and its plain twin."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..fields.limbs import add_plain, mul_plain

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


def horner(F, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Values (L, k) of the polynomial coeffs (L, d) at the points x (L, k).
    CUDA tensors launch K10 (once for d <= 256, else twice: the chunk scan
    and the combine); CPU tensors run the plain twin."""
    check_limbs("horner(coeffs)", coeffs)
    check_limbs("horner(x)", x, coeffs.device)
    if coeffs.ndim != 2 or x.ndim != 2 or coeffs.shape[0] != F.L \
            or x.shape[0] != F.L:
        raise ValueError(f"horner: bad shapes coeffs={tuple(coeffs.shape)} "
                         f"x={tuple(x.shape)}")
    if coeffs.device.type == "cpu":
        return horner_plain(F, coeffs, x)
    d, k = coeffs.shape[1], x.shape[1]
    m, S = blocking(d)
    dev = coeffs.device
    out = torch.empty((F.L, k), dtype=torch.int32, device=dev)
    acc = out if S == 1 else torch.empty((F.L, S * k), dtype=torch.int32,
                                         device=dev)
    fn = build.launcher("horner", "horner_chunks_launch", _CHUNKS_ARGTYPES)
    err = fn(ptr(acc), ptr(coeffs), ptr(x), d, m, S, k, field_words(F),
             F.kernel_params(), stream_ptr(dev))
    raise_on_error("horner", err)
    LAUNCHES["horner"] += 1
    if S > 1:
        fn = build.launcher("horner", "horner_combine_launch",
                            _COMBINE_ARGTYPES)
        err = fn(ptr(out), ptr(acc), ptr(x), m, S, k, field_words(F),
                 F.kernel_params(), stream_ptr(dev))
        raise_on_error("horner", err)
        LAUNCHES["horner"] += 1
    return out
