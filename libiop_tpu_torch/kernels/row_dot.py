"""K15: row inner product wrapper (csrc/row_dot.cu) and its plain twins,
over a prime field (Montgomery limbs) or GF(2^k) (words, an XOR sum)."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.binary import xor_reduce
from ..fields.limbs import lazy_sum_reduce_plain, mul_plain
from .gf2k_mul import gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p]
_GF2_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def accumulator_cap(F) -> int:
    """The most products of values below p whose sum T the kernel's one
    Montgomery reduction takes (T < p * 2^(32W))."""
    return min((F.p * (1 << (16 * F.L)) - 1) // (F.p - 1) ** 2, 1 << 30)


def row_dot_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The products, a limb-wise lazy sum over the row axis and one
    reduction (the reference's F.mul then _row_sum); over GF(2^k) the
    products XOR-folded over the rows."""
    if F.kind == "additive":
        return xor_reduce(gf2k_mul_plain(F, a, b), dim=1)
    prod = mul_plain(F, a, b)
    return lazy_sum_reduce_plain(F, prod.to(torch.int64).sum(dim=1))


def row_dot(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L, N) Montgomery limbs of sum_i a[:, i, j] * b[:, i, j] for a
    (L, R, N) and b (L, R, N) or (L, R, 1) (one element per row); over
    GF(2^k) the (W, N) words of the XOR sum.  CUDA tensors launch K15;
    CPU tensors run the plain twin."""
    check_limbs("row_dot(a)", a)
    check_limbs("row_dot(b)", b, a.device)
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != F.L \
            or b.shape[:2] != a.shape[:2] or b.shape[2] not in (1, a.shape[2]):
        raise ValueError(f"row_dot: bad shapes a={tuple(a.shape)} "
                         f"b={tuple(b.shape)}")
    if a.device.type == "cpu":
        return row_dot_plain(F, a, b)
    _, R, N = a.shape
    out = torch.empty((F.L, N), dtype=torch.int32, device=a.device)
    if F.kind == "additive":
        fn = build.launcher("row_dot", "row_dot_gf2_launch", _GF2_ARGTYPES)
        err = fn(ptr(out), ptr(a), ptr(b), R, N, b.shape[2], binary_words(F),
                 F.kernel_params(), stream_ptr(a.device))
        raise_on_error("row_dot", err)
        LAUNCHES["row_dot"] += 1
        return out
    fn = build.launcher("row_dot", "row_dot_launch", _ARGTYPES)
    r_mod_p = F.ones((1,), a.device)  # 2^(32W) mod p, the fold's factor
    err = fn(ptr(out), ptr(a), ptr(b), R, N, b.shape[2], accumulator_cap(F),
             ptr(r_mod_p), field_words(F), F.kernel_params(),
             stream_ptr(a.device))
    raise_on_error("row_dot", err)
    LAUNCHES["row_dot"] += 1
    return out
