"""K2: radix-2 DIT butterfly stage wrapper (csrc/ntt.cu) and its plain twin."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, mul_plain, sub_plain

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def ntt_stage_plain(F, x: torch.Tensor, W: torch.Tensor, m: int) -> torch.Tensor:
    """One stage over x (L, rows, N): blocks of 2m, twiddles W[:, ::N/2m][:m]."""
    L, rows, N = x.shape
    w = W[:, ::N // (2 * m)][:, :m].reshape(L, 1, 1, m)
    xb = x.reshape(L, rows, N // (2 * m), 2 * m)
    a, b = xb[..., :m], xb[..., m:]
    t = mul_plain(F, w, b)
    return torch.cat([add_plain(F, a, t), sub_plain(F, a, t)],
                     dim=-1).reshape(L, rows, N)


def ntt_stage(F, x: torch.Tensor, W: torch.Tensor, m: int) -> torch.Tensor:
    """One butterfly stage of size-2m blocks over every row of x (L, rows, N)
    with twiddle table W (L, N).  On the card the stage runs IN PLACE on x
    (the caller must not reuse the input); returns the result."""
    check_limbs("ntt_stage(x)", x)
    check_limbs("ntt_stage(W)", W, x.device)
    L, rows, N = x.shape
    if L != F.L or tuple(W.shape) != (F.L, N) or not (1 <= m < N) \
            or N % (2 * m):
        raise ValueError(f"ntt_stage: bad shapes x={tuple(x.shape)} "
                         f"W={tuple(W.shape)} m={m}")
    if x.device.type == "cpu":
        return ntt_stage_plain(F, x, W, m)
    fn = build.launcher("ntt", "ntt_stage_launch", _ARGTYPES)
    err = fn(ptr(x), ptr(W), rows, N, m, field_words(F), F.kernel_params(),
             stream_ptr(x.device))
    raise_on_error("ntt_stage", err)
    LAUNCHES["ntt_stage"] += 1
    return x
