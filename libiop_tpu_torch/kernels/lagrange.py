"""K25: the Lagrange basis of a domain at a point (csrc/lagrange.cu) and its
plain twin, over a prime field (Montgomery limbs) or GF(2^k) (words)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words,
               host_words, ptr, raise_on_error, stream_ptr)
from ..fields.limbs import mul_plain, sub_plain
from .batch_inv import batch_inv_plain
from .gf2k_mul import gf2k_mul_plain

_PRIME_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]
_BINARY_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def lagrange_coeffs_plain(F, hs: torch.Tensor, ws: Optional[torch.Tensor],
                          scal: torch.Tensor) -> torch.Tensor:
    """zeta * w_k / (alpha - h_k) over the (L, n) table hs, with alpha =
    scal[:, 0], zeta = scal[:, 1] and w_k = ws[:, k] (1 when ws is None);
    the one-hot vector of alpha's position when some h_k equals alpha: the
    field's plain subtraction, then K20's plain twin (Montgomery's trick
    with the numerator fused)."""
    alpha, zeta = scal[:, 0:1], scal[:, 1:2]
    if F.kind == "additive":
        den = hs ^ alpha
        num = zeta.expand_as(hs) if ws is None else gf2k_mul_plain(F, ws, zeta)
    else:
        den = sub_plain(F, alpha, hs)
        num = zeta.expand_as(hs) if ws is None else mul_plain(F, ws, zeta)
    coeffs = batch_inv_plain(F, den, num.contiguous())
    member = (den == 0).all(dim=0)
    onehot = torch.where(member, F.ones(member.shape, hs.device),
                         F.zeros(member.shape, hs.device))
    return torch.where(member.any(), onehot, coeffs)


def lagrange_coeffs(F, hs: torch.Tensor, ws: Optional[torch.Tensor],
                    scal: torch.Tensor) -> torch.Tensor:
    """L_k(alpha) = zeta * w_k * (alpha - h_k)^-1 for every element h_k of
    the (L, n) table hs, with alpha and zeta the two elements of the device
    buffer scal (L, 2) and w_k the (L, n) table ws (None for w_k = 1); the
    one-hot vector of alpha's position when zeta is 0 (alpha in H).  CUDA
    tensors launch K25 once (its GF(2^k) instantiation for a binary field,
    counted as lagrange_coeffs_gf2); CPU tensors run the plain twin."""
    check_limbs("lagrange_coeffs(hs)", hs)
    check_limbs("lagrange_coeffs(scal)", scal, hs.device)
    if hs.ndim != 2 or hs.shape[0] != F.L or tuple(scal.shape) != (F.L, 2):
        raise ValueError(f"lagrange_coeffs: hs {tuple(hs.shape)} must be "
                         f"({F.L}, n) and scal {tuple(scal.shape)} ({F.L}, 2)")
    if ws is not None:
        check_limbs("lagrange_coeffs(ws)", ws, hs.device)
        if ws.shape != hs.shape:
            raise ValueError(f"lagrange_coeffs: ws {tuple(ws.shape)} must "
                             f"match hs {tuple(hs.shape)}")
    if hs.device.type == "cpu":
        return lagrange_coeffs_plain(F, hs, ws, scal)
    n = hs.shape[1]
    out = torch.empty_like(hs)
    ws_p = ctypes.c_void_p(None) if ws is None else ptr(ws)
    stream = stream_ptr(hs.device)
    if F.kind == "additive":
        fn = build.launcher("lagrange", "lagrange_gf2_launch",
                            _BINARY_ARGTYPES)
        err = fn(ptr(out), ptr(hs), ws_p, ptr(scal), n, binary_words(F),
                 F.kernel_params(), stream)
        counter = "lagrange_coeffs_gf2"
    else:
        one = host_words(F, [1])
        fn = build.launcher("lagrange", "lagrange_launch", _PRIME_ARGTYPES)
        err = fn(ptr(out), ptr(hs), ws_p, ptr(scal), n,
                 one.ctypes.data_as(ctypes.c_void_p), field_words(F),
                 F.kernel_params(), stream)
        counter = "lagrange_coeffs"
    raise_on_error("lagrange_coeffs", err)
    LAUNCHES[counter] += 1
    return out
