"""K5: modular add / sub / neg wrapper (csrc/field_addsub.cu) and its plain
twins (fields/limbs.py)."""
from __future__ import annotations

import ctypes
import math

import torch

from . import (LAUNCHES, broadcast_operand, build, check_limbs, field_words,
               ptr, raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, sub_plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

_OPS = {"add": 0, "sub": 1, "neg": 2}


def field_addsub_plain(F, op: str, a: torch.Tensor, b=None) -> torch.Tensor:
    if op == "add":
        return add_plain(F, a, b)
    if op == "sub":
        return sub_plain(F, a, b)
    return sub_plain(F, torch.zeros_like(a), a)


def field_addsub(F, op: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """``op`` is "add" (a + b), "sub" (a - b) or "neg" (-a, b unused) mod p,
    for int32 limb tensors (L, *batch) that broadcast over the batch.  CUDA
    tensors launch K5; CPU tensors run the plain twin."""
    if op not in _OPS:
        raise ValueError(f"field_addsub: unknown op {op!r}")
    if op == "neg":
        b = a
    check_limbs("field_addsub(a)", a)
    check_limbs("field_addsub(b)", b, a.device)
    if a.shape[0] != F.L or b.shape[0] != F.L:
        raise ValueError(f"field_addsub: expected {F.L} limbs, got "
                         f"{a.shape[0]} and {b.shape[0]}")
    if a.device.type == "cpu":
        return field_addsub_plain(F, op, a, b)
    out_batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    n = math.prod(out_batch)
    out = torch.empty((F.L,) + out_batch, dtype=torch.int32, device=a.device)
    a, (a_div, a_mod) = broadcast_operand(a, out_batch)
    b, (b_div, b_mod) = broadcast_operand(b, out_batch)
    fn = build.launcher("field_addsub", "field_addsub_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(a), ptr(b), n, a_div, a_mod, b_div, b_mod,
             _OPS[op], field_words(F), F.kernel_params(),
             stream_ptr(a.device))
    raise_on_error("field_addsub", err)
    LAUNCHES["field_addsub"] += 1
    return out
