"""K24: the LDT reducer's combination (csrc/ldt_combine.cu) and its plain
twin, over a prime field (Montgomery limbs) or GF(2^k) (words).

out = sum_k coeff_k f_k with coeff_k = c_k, or c_k + c'_k x^Delta_k for an
input of submaximal degree (``protocols/ldt_reducer.py``
``CombinedLDTOracle``), in one launch over any number of inputs.  The
inputs are the oracle tensors as the runtime holds them (views included):
the kernel reads them through an array of pointers and limb strides.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, lazy_sum_reduce_plain, mul_plain
from .gf2k_mul import gf2k_mul_plain
from .row_dot import accumulator_cap

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p]
_GF2_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _coefficients(F, coeffs, sub_coeffs, device) -> torch.Tensor:
    """(L, 2n): c_k in column k, c'_k (0 for a maximal input) in n + k."""
    cp = [0 if c is None else c for c in sub_coeffs]
    return F.from_ints(list(coeffs) + cp, device)


def ldt_combine_plain(F, inputs: Sequence[torch.Tensor],
                      coeffs: Sequence[int],
                      sub_coeffs: Sequence[Optional[int]],
                      tables: Sequence[Optional[torch.Tensor]]
                      ) -> torch.Tensor:
    """The combination as the reference writes it: each coefficient
    (c_k + c'_k x^Delta_k), its product with f_k, and the sum (a limb-wise
    lazy sum and one reduction; over GF(2^k) an XOR fold)."""
    n = len(inputs)
    c = _coefficients(F, coeffs, sub_coeffs, inputs[0].device)
    binary = F.kind == "additive"
    mul = gf2k_mul_plain if binary else mul_plain
    acc = None
    for k in range(n):
        coeff = c[:, k:k + 1]
        if tables[k] is not None:
            bump = mul(F, tables[k], c[:, n + k:n + k + 1])
            coeff = torch.bitwise_xor(coeff, bump) if binary \
                else add_plain(F, coeff, bump)
        term = mul(F, inputs[k], coeff)
        if binary:
            acc = term if acc is None else torch.bitwise_xor(acc, term)
        else:
            term = term.to(torch.int64)
            acc = term if acc is None else acc + term
    if binary:
        return acc.contiguous()
    return lazy_sum_reduce_plain(F, acc)


def ldt_combine(F, inputs: Sequence[torch.Tensor], coeffs: Sequence[int],
                sub_coeffs: Sequence[Optional[int]],
                tables: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """(L, N) sum_k (c_k + c'_k x^Delta_k) f_k for n inputs f_k (L, N) (any
    limb stride, the last axis contiguous), canonical ints c_k, and for each
    input either None, None (maximal degree) or c'_k and its (L, N) table
    x^Delta_k.  CUDA tensors launch K24; CPU tensors run the plain twin."""
    n = len(inputs)
    if not (n == len(coeffs) == len(sub_coeffs) == len(tables)) or n == 0:
        raise ValueError("ldt_combine: one coefficient, one c' and one table "
                         "entry an input")
    dev = inputs[0].device
    L, N = F.L, inputs[0].shape[-1]
    views: List[torch.Tensor] = []
    for k, f in enumerate(inputs):
        if f.dtype != torch.int32 or f.device != dev or \
                tuple(f.shape) != (L, N):
            raise ValueError(f"ldt_combine: input {k} is {tuple(f.shape)} "
                             f"{f.dtype} on {f.device}, expected ({L}, {N}) "
                             f"int32 on {dev}")
        views.append(f if f.stride(-1) == 1 else f.contiguous())
        if (tables[k] is None) != (sub_coeffs[k] is None):
            raise ValueError(f"ldt_combine: input {k} has a c' without a "
                             "table or a table without a c'")
        if tables[k] is not None:
            check_limbs("ldt_combine(table)", tables[k], dev)
            if tuple(tables[k].shape) != (L, N):
                raise ValueError(f"ldt_combine: table {k} is "
                                 f"{tuple(tables[k].shape)}")
    if dev.type == "cpu":
        return ldt_combine_plain(F, views, coeffs, sub_coeffs, tables)
    c = _coefficients(F, coeffs, sub_coeffs, dev)
    meta = torch.tensor(
        [f.data_ptr() for f in views] + [f.stride(0) for f in views]
        + [0 if t is None else t.data_ptr() for t in tables],
        dtype=torch.int64).to(dev)
    out = torch.empty((L, N), dtype=torch.int32, device=dev)
    if F.kind == "additive":
        fn = build.launcher("ldt_combine", "ldt_combine_gf2_launch",
                            _GF2_ARGTYPES)
        err = fn(ptr(out), ptr(meta), ptr(c), n, N, binary_words(F),
                 F.kernel_params(), stream_ptr(dev))
        raise_on_error("ldt_combine_gf2", err)
        LAUNCHES["ldt_combine_gf2"] += 1
        return out
    fn = build.launcher("ldt_combine", "ldt_combine_launch", _ARGTYPES)
    r_mod_p = F.ones((1,), dev)  # 2^(32W) mod p, the fold's factor
    err = fn(ptr(out), ptr(meta), ptr(c), n, N, accumulator_cap(F),
             ptr(r_mod_p), field_words(F), F.kernel_params(), stream_ptr(dev))
    raise_on_error("ldt_combine", err)
    LAUNCHES["ldt_combine"] += 1
    return out
