"""K18: division by and multiplication by a linearized vanishing polynomial
(csrc/linearized.cu), and their plain twins.

Z is given by its sparse terms [(degree, coefficient int)]; the division
takes the terms below x^h (Z is monic of degree h), the product every term.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from .gf2k_mul import gf2k_mul_plain

MAX_TERMS = 34
#: coefficient stride in the launch parameters (gf::kMaxWords)
MAX_WORDS = 8


class _Terms(ctypes.Structure):
    _fields_ = [("deg", ctypes.c_longlong * MAX_TERMS),
                ("c", ctypes.c_uint32 * (MAX_TERMS * MAX_WORDS)),
                ("n_terms", ctypes.c_int)]


_DIV_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p]
_MUL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _coeff(F, c: int, device) -> torch.Tensor:
    return F.from_ints([c], device).reshape(F.W, 1)


def linearized_divide_plain(F, coeffs: torch.Tensor, terms, h: int):
    """The reference's chunked fold (linearized.py:105-125), the products of
    a chunk by every term in one call."""
    d = coeffs.shape[1]
    work = coeffs.clone()
    cs = F.from_ints([c for _, c in terms], coeffs.device).reshape(
        F.W, len(terms), 1)
    chunk = max(1, h // 2)
    top = d
    while top > h and terms:
        size = min(chunk, top - h)
        prods = gf2k_mul_plain(F, work[:, None, top - size:top], cs)
        for q, (deg, _) in enumerate(terms):
            lo = top - size - h + deg
            work[:, lo:lo + size] ^= prods[:, q]
        top -= size
    return work[:, h:].contiguous(), work[:, :h].contiguous()


def linearized_multiply_plain(F, coeffs: torch.Tensor, terms, h: int):
    """Z * f term by term (generic.py:207-219)."""
    d = coeffs.shape[1]
    out = coeffs.new_zeros((F.W, d + h))
    for deg, c in terms:
        out[:, deg:deg + d] ^= gf2k_mul_plain(F, coeffs,
                                              _coeff(F, c, coeffs.device))
    return out


def _pack_terms(F, terms) -> _Terms:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"linearized: {len(terms)} terms, the kernel takes "
                         f"at most {MAX_TERMS}")
    prm = _Terms()
    for q, (deg, c) in enumerate(terms):
        prm.deg[q] = deg
        for w in range(F.W):
            prm.c[q * MAX_WORDS + w] = (c >> (32 * w)) & 0xFFFFFFFF
    prm.n_terms = len(terms)
    return prm


def _check(F, name, coeffs, terms, h):
    check_limbs(name, coeffs)
    if coeffs.ndim != 2 or coeffs.shape[0] != F.W or h < 1 \
            or any(not 0 <= deg <= h for deg, _ in terms):
        raise ValueError(f"{name}: bad coefficients {tuple(coeffs.shape)} or "
                         f"terms for h = {h}")


def linearized_divide(F, coeffs: torch.Tensor, terms: List[Tuple[int, int]],
                      h: int):
    """(quotient (W, d - h), remainder (W, h)) of (W, d) coefficients,
    d > h, by the monic Z of degree h whose terms below x^h are ``terms``.
    CUDA tensors launch K18 once a chunk of h/2, or once in all when a
    chunk's positions times terms fit one block (a small Z); CPU tensors
    run the plain twin."""
    _check(F, "linearized_divide", coeffs, terms, h)
    if any(deg >= h for deg, _ in terms) or coeffs.shape[1] <= h:
        raise ValueError("linearized_divide: terms must lie below x^h and "
                         "the dividend above it")
    if coeffs.device.type == "cpu":
        return linearized_divide_plain(F, coeffs, terms, h)
    work = coeffs.clone()
    prm = _pack_terms(F, terms)
    count = ctypes.c_int(0)
    fn = build.launcher("linearized", "linearized_divide_launch",
                        _DIV_ARGTYPES)
    err = fn(ptr(work), work.shape[1], h, ctypes.byref(prm), binary_words(F),
             F.kernel_params(), stream_ptr(coeffs.device), ctypes.byref(count))
    raise_on_error("linearized", err)
    LAUNCHES["linearized"] += count.value
    return work[:, h:].contiguous(), work[:, :h].contiguous()


def linearized_multiply(F, coeffs: torch.Tensor, terms: List[Tuple[int, int]],
                        h: int) -> torch.Tensor:
    """(W, d + h) coefficients of Z * f for f (W, d), Z of degree h given by
    all its terms.  CUDA tensors launch K18 once; CPU tensors run the plain
    twin."""
    _check(F, "linearized_multiply", coeffs, terms, h)
    if coeffs.device.type == "cpu":
        return linearized_multiply_plain(F, coeffs, terms, h)
    d = coeffs.shape[1]
    out = torch.empty((F.W, d + h), dtype=torch.int32, device=coeffs.device)
    prm = _pack_terms(F, terms)
    count = ctypes.c_int(0)
    fn = build.launcher("linearized", "linearized_multiply_launch",
                        _MUL_ARGTYPES)
    err = fn(ptr(out), ptr(coeffs), d, h, ctypes.byref(prm), binary_words(F),
             F.kernel_params(), stream_ptr(coeffs.device), ctypes.byref(count))
    raise_on_error("linearized", err)
    LAUNCHES["linearized"] += count.value
    return out
