"""K4: multiplicative FRI fold wrapper (csrc/fri_fold.cu) and its plain twin."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import lazy_sum_reduce_plain, mul_plain

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]


def fri_fold_plain(F, evals, rows, winv, xpow, c: int) -> torch.Tensor:
    """The reference's fold (fri.py:159-172): per t, a_t = lazy sum over k
    of rows[t, k] * v[k, j], times Winv[(j*t) mod N] and xpow[t]; one lazy
    sum over t reduced once."""
    L, N = evals.shape
    nc = N // c
    v = evals.reshape(L, c, nc)
    rows3 = rows.reshape(L, c, c)
    jj = torch.arange(nc, device=evals.device, dtype=torch.int64)
    acc = None
    for t in range(c):
        m = mul_plain(F, v, rows3[:, t, :, None])
        a_t = lazy_sum_reduce_plain(F, m.to(torch.int64).sum(dim=1))
        tw = winv.index_select(1, (jj * t) % N)
        term = mul_plain(F, mul_plain(F, a_t, tw), xpow[:, t:t + 1])
        acc = term.to(torch.int64) if acc is None else acc + term
    return lazy_sum_reduce_plain(F, acc)


def fri_fold(F, evals, rows, winv, xpow, c: int) -> torch.Tensor:
    """Fold a (L, N) codeword into (L, N/c) with the inverse mini-NTT table
    rows (L, c*c), the domain's inverse generator powers winv (L, N) and the
    challenge powers xpow (L, c) = (x/shift)^t."""
    for name, t in (("evals", evals), ("rows", rows), ("winv", winv),
                    ("xpow", xpow)):
        check_limbs(f"fri_fold({name})", t, evals.device)
    L, N = evals.shape
    if c not in (2, 4, 8, 16) or N % c or tuple(rows.shape) != (F.L, c * c) \
            or tuple(winv.shape) != (F.L, N) or tuple(xpow.shape) != (F.L, c) \
            or L != F.L:
        raise ValueError(f"fri_fold: bad shapes evals={tuple(evals.shape)} "
                         f"c={c}")
    if evals.device.type == "cpu":
        return fri_fold_plain(F, evals, rows, winv, xpow, c)
    out = torch.empty((F.L, N // c), dtype=torch.int32, device=evals.device)
    fn = build.launcher("fri_fold", "fri_fold_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(evals), ptr(rows), ptr(winv), ptr(xpow), N, c,
             field_words(F), F.kernel_params(), stream_ptr(evals.device))
    raise_on_error("fri_fold", err)
    LAUNCHES["fri_fold"] += 1
    return out
