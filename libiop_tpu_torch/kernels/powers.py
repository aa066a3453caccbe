"""K11: power-table wrapper (csrc/powers.cu) and its plain twins, over a
prime field (Montgomery limbs) or GF(2^k) (words)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import mul_plain
from .gf2k_mul import gf2k_mul_plain, gf2k_square_plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]


def powers_plain(F, x: torch.Tensor, n: int,
                 start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[start * x^i, i < n] by doubling: the table so far times x^(2^j)."""
    out = (start if start is not None else F.ones((1,), x.device)).reshape(
        F.L, 1)
    s = x.reshape(F.L, 1)
    while out.shape[1] < n:
        out = torch.cat([out, mul_plain(F, out, s)], dim=1)
        s = mul_plain(F, s, s)
    return out[:, :n].contiguous()


def powers_gf2_plain(F, x: torch.Tensor, n: int,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[start * x^i, i < n] over GF(2^k) by the same doubling."""
    out = (start if start is not None else F.ones((1,), x.device)).reshape(
        F.W, 1)
    s = x.reshape(F.W, 1)
    while out.shape[1] < n:
        out = torch.cat([out, gf2k_mul_plain(F, out, s)], dim=1)
        s = gf2k_square_plain(F, s)
    return out[:, :n].contiguous()


def powers(F, x: torch.Tensor, n: int,
           start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L, n) [start * x^i, i < n] for one element x (L,) and an optional
    element start (L,) (one when None), Montgomery limbs or GF(2^k) words.
    CUDA tensors launch K11 (its GF(2^k) instantiation for a binary field);
    CPU tensors run the plain twin."""
    check_limbs("powers(x)", x)
    if start is not None:
        check_limbs("powers(start)", start, x.device)
    if x.numel() != F.L or (start is not None and start.numel() != F.L) \
            or n < 0:
        raise ValueError(f"powers: expected one element x and start, n >= 0; "
                         f"got x {tuple(x.shape)}, n = {n}")
    binary = F.kind == "additive"
    if x.device.type == "cpu":
        return (powers_gf2_plain if binary else powers_plain)(F, x, n, start)
    if start is None:
        start = F.ones((1,), x.device)
    out = torch.empty((F.L, n), dtype=torch.int32, device=x.device)
    name, words, counter = ("powers_gf2_launch", binary_words(F),
                            "powers_gf2") if binary else \
        ("powers_launch", field_words(F), "powers")
    fn = build.launcher("powers", name, _ARGTYPES)
    err = fn(ptr(out), ptr(x), ptr(start.contiguous()), n, words,
             F.kernel_params(), stream_ptr(x.device))
    raise_on_error("powers", err)
    LAUNCHES[counter] += 1
    return out
