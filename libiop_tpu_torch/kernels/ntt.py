"""K2: the radix-2 DIT butterfly stages of the NTT (csrc/ntt.cu), run as at
most two multi-stage passes in shared memory, and their plain twins.

``ntt_plan`` splits the stages m = first_m, ..., N/2 into a tile pass (the
stages inside tiles of T = min(TILE, N) consecutive positions) and a column
pass (the stages m >= T, over the positions equal mod T); each pass is one
launch, counted under ``LAUNCHES["ntt_stage"]``.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, mul_plain, sub_plain

#: positions of a tile: the tile pass runs every stage with 2m <= TILE
TILE = 1 << 12
#: the most positions one block holds in shared memory (both passes); two
#: passes cover N <= TILE * SPAN
SPAN = 1 << 12

_TILE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 5 + \
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_COLUMN_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 5 + \
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


def ntt_stages_plain(F, x: torch.Tensor, W: torch.Tensor,
                     first_m: int) -> torch.Tensor:
    """Stages m = first_m, 2 first_m, ..., N/2 over x (L, rows, N), one
    ntt_stage_plain each."""
    m = first_m
    while m < x.shape[-1]:
        x = ntt_stage_plain(F, x, W, m)
        m *= 2
    return x


def ntt_plan(N: int, first_m: int):
    """The passes of stages m = first_m, ..., N/2 as (kind, first stage,
    last stage): a "tile" pass over the stages with 2m <= T = min(TILE, N),
    then a "column" pass over the stages m >= T.  Empty when first_m >= N."""
    T = min(TILE, N)
    passes = []
    if first_m < T:
        passes.append(("tile", first_m, T // 2))
    if N > T and max(first_m, T) < N:
        passes.append(("column", max(first_m, T), N // 2))
    return passes


def column_width(N: int, T: int) -> int:
    """Columns C a column-pass block holds for tiles of T: its N/T
    positions each, SPAN positions in all (at most T columns)."""
    return min(T, max(1, SPAN // (N // T)))


#: (id of a twiddle table, T) -> (a weak reference to it, its tile table)
_TILE_TABLES = {}


def _tile_table(W: torch.Tensor, N: int, T: int):
    """(table, limb stride) of the tile pass's twiddles W[:, j N/T], j <
    T/2: the table itself when T = N, else a contiguous (L, T/2) copy
    memoized per twiddle table (the domains memoize theirs)."""
    if T == N:
        return W, N
    key = (id(W), T)
    hit = _TILE_TABLES.get(key)
    if hit is None or hit[0]() is not W:
        hit = (weakref.ref(W, lambda _, k=key: _TILE_TABLES.pop(k, None)),
               W[:, ::N // T][:, :T // 2].contiguous())
        _TILE_TABLES[key] = hit
    return hit[1], T // 2


def ntt_stages(F, x: torch.Tensor, W: torch.Tensor,
               first_m: int) -> torch.Tensor:
    """Butterfly stages m = first_m, ..., N/2 over every row of x
    (L, rows, N) with twiddle table W (L, N).  On the card the passes of
    ntt_plan run IN PLACE on x (the caller must not reuse the input), one
    launch each; returns the result.  CPU tensors run the plain twin."""
    check_limbs("ntt_stages(x)", x)
    check_limbs("ntt_stages(W)", W, x.device)
    L, rows, N = x.shape
    if L != F.L or tuple(W.shape) != (F.L, N) or N & (N - 1) \
            or not 1 <= first_m or first_m & (first_m - 1) \
            or N > TILE * SPAN:
        raise ValueError(f"ntt_stages: bad shapes x={tuple(x.shape)} "
                         f"W={tuple(W.shape)} first_m={first_m}")
    if x.device.type == "cpu":
        return ntt_stages_plain(F, x, W, first_m)
    words, field = field_words(F), F.kernel_params()
    stream = stream_ptr(x.device)
    T = min(TILE, N)
    for kind, m, _ in ntt_plan(N, first_m):
        if kind == "tile":
            tw, tw_stride = _tile_table(W, N, T)
            fn = build.launcher("ntt", "ntt_tile_pass_launch", _TILE_ARGTYPES)
            err = fn(ptr(x), ptr(tw), tw_stride, rows * N, T,
                     min(SPAN, rows * N), m, words, field, stream)
        else:
            fn = build.launcher("ntt", "ntt_column_pass_launch",
                                _COLUMN_ARGTYPES)
            err = fn(ptr(x), ptr(W), rows, N, T, column_width(N, T), m,
                     words, field, stream)
        raise_on_error("ntt_stage", err)
        LAUNCHES["ntt_stage"] += 1
    return x
