"""K22: the bivariate Lagrange evaluations (csrc/bivariate.cu) and their
plain twin, over a prime field (Montgomery limbs) or GF(2^k) (words)."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words,
               host_words, ptr, raise_on_error, stream_ptr)
from ..fields.limbs import sub_plain
from .batch_inv import batch_inv_plain

_PRIME_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]
_BINARY_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def bivariate_evals_plain(F, ys: torch.Tensor, zy: torch.Tensor, x: int,
                          zx: int, zpx: int, diag: int) -> torch.Tensor:
    """(Z_S(x) - Z_S(y)) / (x - y) over the (L, n) tables ys and zy = Z_S(ys),
    0 where x - y is 0, Z_S'(x) at index diag (none when diag < 0): the
    field's plain subtraction, then K20's plain twin (Montgomery's trick
    with the numerator fused)."""
    scal = F.from_ints([x, zx, zpx], ys.device)
    if F.kind == "additive":
        num, den = zy ^ scal[:, 1:2], ys ^ scal[:, 0:1]
    else:
        num = sub_plain(F, scal[:, 1:2], zy)
        den = sub_plain(F, scal[:, 0:1], ys)
    out = batch_inv_plain(F, den, num)
    if diag >= 0:
        out[:, diag] = scal[:, 2]
    return out


def bivariate_evals(F, ys: torch.Tensor, zy: torch.Tensor, x: int, zx: int,
                    zpx: int, diag: int) -> torch.Tensor:
    """f(x, y) = (Z_S(x) - Z_S(y)) (x - y)^-1 for every y of the (L, n)
    table ys, with zy = Z_S(ys), zx = Z_S(x), zpx = Z_S'(x) (host ints) and
    diag the index of x in ys (or -1): 0 where x - y = 0, Z_S'(x) at diag.
    CUDA tensors launch K22 (its GF(2^k) instantiation for a binary field,
    counted as bivariate_gf2); CPU tensors run the plain twin."""
    check_limbs("bivariate_evals(ys)", ys)
    check_limbs("bivariate_evals(zy)", zy, ys.device)
    if ys.shape != zy.shape or ys.ndim != 2 or ys.shape[0] != F.L:
        raise ValueError(f"bivariate_evals: ys {tuple(ys.shape)} and zy "
                         f"{tuple(zy.shape)} must both be ({F.L}, n)")
    n = ys.shape[1]
    if not -1 <= diag < n:
        raise ValueError(f"bivariate_evals: diagonal index {diag} outside "
                         f"[-1, {n})")
    if ys.device.type == "cpu":
        return bivariate_evals_plain(F, ys, zy, x, zx, zpx, diag)
    out = torch.empty_like(ys)
    scal = host_words(F, [x, zx, zpx])
    scal_p = scal.ctypes.data_as(ctypes.c_void_p)
    stream = stream_ptr(ys.device)
    if F.kind == "additive":
        fn = build.launcher("bivariate", "bivariate_gf2_launch",
                            _BINARY_ARGTYPES)
        err = fn(ptr(out), ptr(ys), ptr(zy), n, diag, scal_p,
                 binary_words(F), F.kernel_params(), stream)
        counter = "bivariate_gf2"
    else:
        one = host_words(F, [1])
        fn = build.launcher("bivariate", "bivariate_launch", _PRIME_ARGTYPES)
        err = fn(ptr(out), ptr(ys), ptr(zy), n, diag, scal_p,
                 one.ctypes.data_as(ctypes.c_void_p), field_words(F),
                 F.kernel_params(), stream)
        counter = "bivariate"
    raise_on_error("bivariate", err)
    LAUNCHES[counter] += 1
    return out
