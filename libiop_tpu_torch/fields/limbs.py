"""Plain PyTorch limb arithmetic behind PrimeField (the reference's
``_carry_canonicalize`` / ``_cond_sub_p`` / 16-bit-step Montgomery
reduction, libiop_tpu/fields/prime.py:197-230, 361-399).

Limb rows are int32 tensors holding values < 2^16; sums and products are
formed in int64, whose headroom replaces the reference's uint32 lazy-limb
bounds.  These functions are the plain versions of the kernels in
``kernels/``: the CPU runs them, and the card runs the kernels.
"""
from __future__ import annotations

from typing import List

import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def carry_canonicalize(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Propagate carries so every limb < 2^16; appends the final carry."""
    out = []
    c = None
    for v in rows:
        if c is not None:
            v = v + c
        out.append(v & LIMB_MASK)
        c = v >> LIMB_BITS
    if c is not None:
        out.append(c)
    return out


def cond_sub_p(F, rows: List[torch.Tensor]) -> torch.Tensor:
    """Canonical limbs (L or L+1 rows, value < 2p) -> the value mod p as an
    int32 (L, *batch) tensor."""
    L = F.L
    rows = list(rows)
    while len(rows) < L + 1:
        rows.append(torch.zeros_like(rows[0]))
    borrow = torch.zeros_like(rows[0])
    sub = []
    for i in range(L + 1):
        pi = int(F.p_limbs[i]) if i < L else 0
        d = rows[i] - pi - borrow
        sub.append(d & LIMB_MASK)
        borrow = (d < 0).to(d.dtype)
    ge = borrow == 0
    out = torch.stack([torch.where(ge, sub[i], rows[i]) for i in range(L)])
    return out.to(torch.int32)


def mont_reduce_rows(F, t: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce an int64 (2L+2, *batch) accumulator 16 bits at a
    time: value(t) * R^-1, canonicalized, truncated to L+1 limbs and
    conditionally reduced, exactly as the reference does."""
    L = F.L
    t = t.clone()
    p_col = F.p_limbs_tensor(t.device, torch.int64).reshape(
        (L,) + (1,) * (t.ndim - 1))
    pinv = int(F.pinv16)
    for i in range(L):
        ti = t[i]
        lo16 = ti & LIMB_MASK
        m = (lo16 * pinv) & LIMB_MASK
        mp = m.unsqueeze(0) * p_col
        lo = mp & LIMB_MASK
        hi = mp >> LIMB_BITS
        t[i + 1] += (ti >> LIMB_BITS) + ((lo16 + lo[0]) >> LIMB_BITS)
        t[i + 1:i + L] += lo[1:]
        t[i + 1:i + L + 1] += hi
    res = carry_canonicalize([t[k] for k in range(L, 2 * L + 2)])
    return cond_sub_p(F, res[:L + 1])


def mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p with broadcasting over the batch
    (the plain twin of kernel K1)."""
    L = F.L
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    t = torch.zeros((2 * L + 2,) + tuple(batch), dtype=torch.int64,
                    device=a.device)
    for i in range(L):
        t[i:i + L] += a64[i].unsqueeze(0) * b64
    return mont_reduce_rows(F, t)


def mont_reduce_wide_plain(F, t: torch.Tensor) -> torch.Tensor:
    """value(t) * R^-1 mod p of a lazy int64 limb accumulator t (K <= 2L+2
    rows of 16-bit weight, columns summed without carries), canonical L
    limbs (the plain twin of kernel K6)."""
    T = 2 * F.L + 2
    K = t.shape[0]
    assert K <= T, K
    t = t.to(torch.int64)
    if K < T:
        t = torch.cat([t, t.new_zeros((T - K,) + tuple(t.shape[1:]))])
    return mont_reduce_rows(F, t)


def lazy_sum_reduce_plain(F, t: torch.Tensor) -> torch.Tensor:
    """Montgomery form of the sum behind a lazy int64 limb sum t, i.e.
    value(t) mod p (the plain twin of kernel K6)."""
    return mul_plain(F, mont_reduce_wide_plain(F, t),
                     F.r2_limbs(t.device, t.ndim))


def add_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    rows = carry_canonicalize([a[i] + b[i] for i in range(F.L)])
    return cond_sub_p(F, rows)


def sub_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + p - b with arithmetic-shift borrow propagation."""
    a, b = torch.broadcast_tensors(a, b)
    out = []
    c = None
    for i in range(F.L):
        v = a[i] + int(F.p_limbs[i]) - b[i]
        if c is not None:
            v = v + c
        out.append(v & LIMB_MASK)
        c = v >> LIMB_BITS
    out.append(c)
    return cond_sub_p(F, out)
