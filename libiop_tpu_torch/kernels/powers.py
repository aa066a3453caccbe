"""K11: power-table wrapper (csrc/powers.cu) and its plain twin."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..fields.limbs import mul_plain

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


def powers(F, x: torch.Tensor, n: int,
           start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L, n) Montgomery limbs [start * x^i, i < n] for one element x (L,)
    and an optional element start (L,) (one when None).  CUDA tensors
    launch K11; CPU tensors run the plain twin."""
    check_limbs("powers(x)", x)
    if start is not None:
        check_limbs("powers(start)", start, x.device)
    if x.numel() != F.L or (start is not None and start.numel() != F.L) \
            or n < 0:
        raise ValueError(f"powers: expected one element x and start, n >= 0; "
                         f"got x {tuple(x.shape)}, n = {n}")
    if x.device.type == "cpu":
        return powers_plain(F, x, n, start)
    if start is None:
        start = F.ones((1,), x.device)
    out = torch.empty((F.L, n), dtype=torch.int32, device=x.device)
    fn = build.launcher("powers", "powers_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(x), ptr(start.contiguous()), n, field_words(F),
             F.kernel_params(), stream_ptr(x.device))
    raise_on_error("powers", err)
    LAUNCHES["powers"] += 1
    return out
