"""K12: multiplication and division by a vanishing polynomial x^h - a
(csrc/vanishing.cu) and their plain twins."""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..fields.limbs import add_plain, mul_plain

_DIV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_MUL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

#: threads the division's chunk passes aim to fill the card with
_DIVIDE_THREADS = 1 << 15


def divide_chunk(h: int, nb: int) -> int:
    """Blocks per chunk G of K12's division of nb blocks of h columns: at
    most sqrt(nb) chunks (the carry pass walks them in turn), and no more
    than fill the card with (chunk, column) threads, so a wide h gets one
    chunk (one pass)."""
    nc = max(1, min(math.isqrt(nb - 1) + 1, -(-_DIVIDE_THREADS // h)))
    return -(-nb // nc)


def vanishing_divide_plain(F, f: torch.Tensor, a: torch.Tensor, h: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic division of f = sum_t B_t y^t (y = x^h, blocks B_t of h
    columns) by y - a: Q_(t-1) = B_t + a Q_t from the top block down."""
    nb = f.shape[1] // h
    blocks = f.reshape(F.L, nb, h)
    a = a.reshape(F.L, 1)
    acc = blocks[:, nb - 1]
    q = []
    for t in range(nb - 1, 0, -1):
        q.append(acc)
        acc = add_plain(F, mul_plain(F, acc, a), blocks[:, t - 1])
    quotient = torch.stack(q[::-1], dim=1).reshape(F.L, (nb - 1) * h) if q \
        else f.new_zeros((F.L, 0))
    return quotient, acc.contiguous()


def vanishing_divide(F, f: torch.Tensor, a: torch.Tensor, h: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quotient, remainder) of f (L, nb*h) by x^h - a, for the element a
    (L,): quotient (L, (nb-1)*h), remainder (L, h).  CUDA tensors launch
    K12; CPU tensors run the plain twin."""
    check_limbs("vanishing_divide(f)", f)
    check_limbs("vanishing_divide(a)", a, f.device)
    if f.ndim != 2 or f.shape[0] != F.L or h < 1 or f.shape[1] % h \
            or f.shape[1] < h or a.numel() != F.L:
        raise ValueError(f"vanishing_divide: bad shapes f={tuple(f.shape)} "
                         f"h={h}")
    if f.device.type == "cpu":
        return vanishing_divide_plain(F, f, a, h)
    nb = f.shape[1] // h
    G = divide_chunk(h, nb)
    nc = -(-nb // G)
    q = torch.empty((F.L, (nb - 1) * h), dtype=torch.int32, device=f.device)
    rem = torch.empty((F.L, h), dtype=torch.int32, device=f.device)
    scratch = torch.empty((F.L, 2 * nc * h if nc > 1 else 1),
                          dtype=torch.int32, device=f.device)
    fn = build.launcher("vanishing", "vanishing_divide_launch", _DIV_ARGTYPES)
    err = fn(ptr(q), ptr(rem), ptr(f), ptr(a), ptr(scratch), h, nb, G,
             field_words(F), F.kernel_params(), stream_ptr(f.device))
    raise_on_error("vanishing", err)
    LAUNCHES["vanishing"] += 1 if nc == 1 else 3
    return q, rem


def vanishing_multiply_plain(F, f: torch.Tensor, neg_a: torch.Tensor,
                             h: int) -> torch.Tensor:
    """(x^h - a) f: -a f in columns 0..d-1, plus f shifted up by h."""
    d = f.shape[1]
    out = torch.zeros((F.L, d + h), dtype=torch.int32, device=f.device)
    out[:, :d] = mul_plain(F, f, neg_a.reshape(F.L, 1))
    out[:, h:] = add_plain(F, out[:, h:], f)
    return out


def vanishing_multiply(F, f: torch.Tensor, neg_a: torch.Tensor,
                       h: int) -> torch.Tensor:
    """Coefficients (L, d + h) of (x^h - a) f for f (L, d) and the element
    neg_a = -a (L,).  CUDA tensors launch K12; CPU tensors run the plain
    twin."""
    check_limbs("vanishing_multiply(f)", f)
    check_limbs("vanishing_multiply(neg_a)", neg_a, f.device)
    if f.ndim != 2 or f.shape[0] != F.L or h < 1 or neg_a.numel() != F.L:
        raise ValueError(f"vanishing_multiply: bad shapes f={tuple(f.shape)} "
                         f"h={h}")
    if f.device.type == "cpu":
        return vanishing_multiply_plain(F, f, neg_a, h)
    d = f.shape[1]
    out = torch.empty((F.L, d + h), dtype=torch.int32, device=f.device)
    fn = build.launcher("vanishing", "vanishing_multiply_launch",
                        _MUL_ARGTYPES)
    err = fn(ptr(out), ptr(f), ptr(neg_a), d, h, field_words(F),
             F.kernel_params(), stream_ptr(f.device))
    raise_on_error("vanishing", err)
    LAUNCHES["vanishing"] += 1
    return out
