"""K1: Montgomery product wrapper (csrc/mont_mul.cu) and its plain twin."""
from __future__ import annotations

import ctypes
import math

import torch

from . import (LAUNCHES, broadcast_operand, build, check_limbs, field_words,
               ptr, raise_on_error, stream_ptr)
from ..fields.limbs import mul_plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def mont_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p for int32 limb tensors (L, *batch_a), (L, *batch_b)
    that broadcast over the batch.  CUDA tensors launch K1; CPU tensors run
    the plain twin."""
    check_limbs("mont_mul(a)", a)
    check_limbs("mont_mul(b)", b, a.device)
    if a.shape[0] != F.L or b.shape[0] != F.L:
        raise ValueError(f"mont_mul: expected {F.L} limbs, got "
                         f"{a.shape[0]} and {b.shape[0]}")
    if a.device.type == "cpu":
        return mul_plain(F, a, b)
    out_batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    n = math.prod(out_batch)
    out = torch.empty((F.L,) + out_batch, dtype=torch.int32, device=a.device)
    a, (a_div, a_mod) = broadcast_operand(a, out_batch)
    b, (b_div, b_mod) = broadcast_operand(b, out_batch)
    fn = build.launcher("mont_mul", "mont_mul_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(a), ptr(b), n, a_div, a_mod, b_div, b_mod,
             field_words(F), F.kernel_params(), stream_ptr(a.device))
    raise_on_error("mont_mul", err)
    LAUNCHES["mont_mul"] += 1
    return out
