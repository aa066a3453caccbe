"""K20: batched inverse with a fused numerator (csrc/batch_inv.cu) and its
plain twin."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import mul_plain
from .gf2k_mul import gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]


def batch_inv_plain(F, a: torch.Tensor, c: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """c * a^-1 with 0 mapping to 0, the reference's a^(p-2), by
    Montgomery's trick over a product tree: pairwise products up to the
    root (zeros and padding enter as 1), the root inverted as a host int,
    then each node's inverse times its sibling down to the leaves.  Over
    GF(2^k) (words) the same trick runs on K16's plain products: K22's
    twin uses it there."""
    binary = F.kind == "additive"

    def mul(u, v):
        return (gf2k_mul_plain if binary else mul_plain)(F, u, v)

    shape = a.shape
    x = a.reshape(F.L, -1)
    n = x.shape[1]
    one = F.ones((1,), x.device)
    zero = (x == 0).all(dim=0)
    width = 1 << max(n - 1, 0).bit_length()
    level = torch.cat([torch.where(zero, one, x),
                       one.expand(F.L, width - n)], dim=1)
    levels = [level]
    while level.shape[1] > 1:
        level = mul(level[:, 0::2].contiguous(), level[:, 1::2].contiguous())
        levels.append(level)
    if binary:
        inv = F.from_ints([F.inv_int(int(F.to_ints(level)[0]))], x.device)
    else:
        unit = torch.zeros((F.L, 1), dtype=torch.int32, device=x.device)
        unit[0] = 1  # the canonical limbs of 1: a product by it leaves
        root = mul(level, unit)[:, 0].tolist()  # Montgomery form
        value = sum(limb << (16 * i) for i, limb in enumerate(root))
        inv = F.from_ints([pow(value, F.p - 2, F.p)], x.device)
    for children in reversed(levels[:-1]):
        left = children[:, 0::2].contiguous()
        right = children[:, 1::2].contiguous()
        inv = torch.stack([mul(inv, right), mul(inv, left)],
                          dim=2).reshape(F.L, -1)
    out = torch.where(zero, torch.zeros_like(x), inv[:, :n])
    if c is not None:
        out = mul(out, c.reshape(F.L, -1))
    return out.reshape(shape)


def batch_inv(F, a: torch.Tensor, c: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """c * a^-1 elementwise for Montgomery limb tensors a and c of one shape
    (L, *batch), with 0^-1 = 0 and c = 1 when it is None.  CUDA tensors
    launch K20; CPU tensors run the plain twin."""
    check_limbs("batch_inv(a)", a)
    if c is not None:
        check_limbs("batch_inv(c)", c, a.device)
        if c.shape != a.shape:
            raise ValueError(f"batch_inv: c {tuple(c.shape)} and a "
                             f"{tuple(a.shape)} differ")
    if a.shape[0] != F.L:
        raise ValueError(f"batch_inv: expected {F.L} limbs, got {a.shape[0]}")
    if a.device.type == "cpu":
        return batch_inv_plain(F, a, c)
    n = a[0].numel()
    out = torch.empty_like(a)
    one = np.array([(F.R >> (32 * j)) & 0xffffffff
                    for j in range(F.L // 2)], dtype=np.uint32)
    fn = build.launcher("batch_inv", "batch_inv_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(a), ptr(c) if c is not None else None, n,
             one.ctypes.data_as(ctypes.c_void_p), field_words(F),
             F.kernel_params(), stream_ptr(a.device))
    raise_on_error("batch_inv", err)
    LAUNCHES["batch_inv"] += 1
    return out
