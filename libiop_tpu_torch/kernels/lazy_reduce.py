"""K6: lazy-accumulator reduction wrapper (csrc/lazy_reduce.cu) and its
plain twins (fields/limbs.py)."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import LAUNCHES, build, field_words, ptr, raise_on_error, stream_ptr
from ..fields.limbs import lazy_sum_reduce_plain, mont_reduce_wide_plain

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _consts(p: int, L: int, montgomery: bool):
    """c0, c1, c2 (see csrc/lazy_reduce.cu) as 18 little-endian u32 words."""
    R = pow(2, 16 * L, p)
    cs = [pow(R, k + montgomery, p) for k in range(3)]
    words = [(c >> (32 * j)) & 0xffffffff for c in cs for j in range(L // 2)]
    return (ctypes.c_uint32 * len(words))(*words)


def lazy_reduce(F, t: torch.Tensor, montgomery: bool) -> torch.Tensor:
    """Reduce a lazy int64 limb accumulator t (K, *batch), K <= 2L+2 rows
    of 16-bit weight, to (L, *batch) canonical int32 limbs: value(t) mod p
    (the Montgomery form of the sum, ``montgomery=True``) or
    value(t) * R^-1 mod p (``False``).  CUDA tensors launch K6; CPU tensors
    run the plain twin."""
    K = t.shape[0]
    if t.dtype != torch.int64 or not t.is_contiguous() \
            or not 1 <= K <= 2 * F.L + 2:
        raise ValueError(f"lazy_reduce: expected a contiguous int64 (K <= "
                         f"{2 * F.L + 2}, *batch) tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device.type == "cpu":
        return (lazy_sum_reduce_plain if montgomery
                else mont_reduce_wide_plain)(F, t)
    batch = tuple(t.shape[1:])
    n = math.prod(batch)
    out = torch.empty((F.L,) + batch, dtype=torch.int32, device=t.device)
    fn = build.launcher("lazy_reduce", "lazy_reduce_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(t), K, n, _consts(F.p, F.L, montgomery),
             field_words(F), F.kernel_params(), stream_ptr(t.device))
    raise_on_error("lazy_reduce", err)
    LAUNCHES["lazy_reduce"] += 1
    return out
