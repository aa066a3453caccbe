"""K13: column-placement wrapper (csrc/place_columns.cu) and its plain twin.

On the card a thread writes 4 adjacent output columns of 4 limb rows: one
16-byte read of its map entries, 16 gathers in flight, a 16-byte store a
row; a column count that is not a multiple of 4, or a map or output that
is not 16-byte aligned, takes the kernel's scalar path.  The per-call host
work is the checks, one allocation and the launch (``build.launcher``
caches the typed launcher)."""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, build, ptr, raise_on_error, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
    [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def place_columns_plain(values: torch.Tensor, inv: torch.Tensor
                        ) -> torch.Tensor:
    """out[..., c] = values[..., inv[c]], zero where inv[c] == nv: a gather
    through the inverse map with a zero sentinel column."""
    padded = torch.cat([values, values.new_zeros(values.shape[:-1] + (1,))],
                       dim=-1)
    return padded.index_select(-1, inv)


def place_columns(values: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(*lead, n) int32 out[..., c] = values[..., inv[c]] (zero where
    inv[c] == nv) for int32 values (*lead, nv) and an int32 or int64
    inverse map inv (n,) with entries in [0, nv].  CUDA tensors launch K13;
    CPU tensors run the plain twin."""
    if values.dtype != torch.int32 or not values.is_contiguous():
        raise ValueError(f"place_columns: expected contiguous int32 values, "
                         f"got {values.dtype}")
    if inv.dtype not in (torch.int32, torch.int64) or inv.ndim != 1 \
            or not inv.is_contiguous() or inv.device != values.device:
        raise ValueError(f"place_columns: expected a contiguous 1-D int32 or "
                         f"int64 inverse map on {values.device}, got "
                         f"{inv.dtype} {tuple(inv.shape)} on {inv.device}")
    if values.device.type == "cpu":
        return place_columns_plain(values, inv)
    nv, n = values.shape[-1], inv.shape[0]
    rows = math.prod(values.shape[:-1])
    out = torch.empty(values.shape[:-1] + (n,), dtype=torch.int32,
                      device=values.device)
    fn = build.launcher("place_columns", "place_columns_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(values), ptr(inv), int(inv.dtype == torch.int64),
             rows, nv, n, stream_ptr(values.device))
    raise_on_error("place_columns", err)
    LAUNCHES["place_columns"] += 1
    return out
