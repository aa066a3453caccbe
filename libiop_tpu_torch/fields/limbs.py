"""Plain PyTorch limb arithmetic behind PrimeField: the plain versions of
the field kernels in ``kernels/`` (the CPU runs them, the card runs the
kernels).  They compute what the reference's ``_carry_canonicalize`` /
``_cond_sub_p`` / 16-bit-step Montgomery reduction compute
(libiop_tpu/fields/prime.py:197-230, 361-399), with the same canonical
results.

Limb rows are int32 tensors holding values < 2^16; sums and products are
formed in int64, whose headroom replaces the reference's uint32 lazy-limb
bounds.  Each function is written as a few whole-tensor steps rather than a
loop over limbs: a product's columns are formed at once (float64, exact
below 2^53), the Montgomery reduction is REDC with the full L-limb
constant -p^-1 mod R (its products with constants are matrix products),
and carries are propagated by whole-array passes (shift every row's carry
into the next row) until none is left.  At the small batches of the CPU
tests the cost of a field op is the number of torch calls it makes, so
this keeps the CPU path fast.
"""
from __future__ import annotations

import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t (K, *batch) cut or zero-padded to ``rows`` rows."""
    K = t.shape[0]
    if K >= rows:
        return t[:rows]
    return torch.cat([t, t.new_zeros((rows - K,) + tuple(t.shape[1:]))])


def carry(t: torch.Tensor, wrap: bool = False,
          wide: bool = False) -> torch.Tensor:
    """Propagate carries through int64 digit rows t (K, *batch), possibly
    negative: every row but the last ends in [0, 2^16) and the last keeps
    the rest of the value (signed).  With ``wrap`` the carry out of the last
    row is dropped instead (the value mod 2^(16K), every row in [0, 2^16)).
    ``wide`` (for rows in [0, 2^63)) starts with one pass that moves bits
    16-31 of every row one row up and the bits above two rows up, which
    leaves rows below 2^17 + 2^15.  Returns a new tensor."""
    K = t.shape[0]
    top = K if wrap else K - 1
    if wide and K > 2:
        out = t & LIMB_MASK
        out[1:] += (t[:-1] >> LIMB_BITS) & LIMB_MASK
        out[2:] += t[:-2] >> (2 * LIMB_BITS)
        if not wrap:        # the last row keeps what would leave it
            out[-1] += ((t[-1] >> LIMB_BITS) << LIMB_BITS) + (
                (t[-2] >> (2 * LIMB_BITS)) << LIMB_BITS)
        t = out
    else:
        t = t.clone()
    while True:
        c = t[:top] >> LIMB_BITS
        if not bool(c.any()):
            return t
        t[:top] &= LIMB_MASK
        if wrap:
            t[1:] += c[:-1]
        else:
            t[1:] += c


def _broadcast(sa, sb) -> tuple:
    """torch.broadcast_shapes of two shapes (without its per-call cost)."""
    n = max(len(sa), len(sb))
    sa = (1,) * (n - len(sa)) + tuple(sa)
    sb = (1,) * (n - len(sb)) + tuple(sb)
    out = []
    for x, y in zip(sa, sb):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {sa} and {sb} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _antidiag(a: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    """Product columns sum_{i+j=k} a_i b_j, k < rows, of 16-bit digit rows
    a (L, *batch_a) and b (L, *batch_b) (batches broadcast), as int64.  The
    sums are formed in float64, exact because every column stays below
    2^36 < 2^53.  Up to 1024 elements, one product of the sliding windows
    of b (zero-padded) with a reversed gives every column at once; a
    larger batch adds one shifted row product at a time (less memory)."""
    L = a.shape[0]
    batch = _broadcast(a.shape[1:], b.shape[1:])
    n = 1
    for x in batch:
        n *= x
    af = a.expand((L,) + batch).reshape(L, n).to(torch.float64)
    bf = b.expand((L,) + batch).reshape(L, n).to(torch.float64)
    if n <= 1024:
        windows = torch.nn.functional.pad(bf, (0, 0, L - 1, L - 1)).unfold(
            0, L, 1)                                  # (2L-1, n, L)
        cols = (windows * af.flip(0).T.unsqueeze(0)).sum(dim=-1)
    else:
        cols = torch.zeros((2 * L - 1, n), dtype=torch.float64,
                           device=a.device)
        for i in range(L):
            cols[i:i + L].addcmul_(af[i], bf)
    return _rows(cols.to(torch.int64), rows).reshape((rows,) + batch)


def _toeplitz(value: int, L: int, rows: int, device) -> torch.Tensor:
    """(rows, L) float64 matrix M[k, j] = digit k-j of value: M @ x gives
    the product columns of the constant value and digit rows x."""
    d = [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)]
    M = torch.zeros((rows, L), dtype=torch.float64)
    for k in range(rows):
        for j in range(max(0, k - L + 1), min(k + 1, L)):
            M[k, j] = d[k - j]
    return M.to(device)


def _consts(F, device):
    """p as int64 digit column (L, 1), and the product matrices of
    n' = -p^-1 mod R (L x L: products mod R) and of p (2L x L)."""
    key = ("redc", str(device))
    hit = F._dev_consts.get(key)
    if hit is None:
        L = F.L
        R = 1 << (LIMB_BITS * L)
        p_col = F.p_limbs_tensor(device, torch.int64).reshape(L, 1)
        hit = F._dev_consts[key] = (
            p_col, _toeplitz((-pow(F.p, -1, R)) % R, L, L, device),
            _toeplitz(F.p, L, 2 * L, device))
    return hit


def cond_sub_p(F, r: torch.Tensor) -> torch.Tensor:
    """Digit rows r (L or L+1 rows, value < 2p) -> the value mod p as an
    int32 (L, *batch) tensor."""
    L = F.L
    r = _rows(r, L + 1)
    p_col = _consts(F, r.device)[0]
    batch_dims = (1,) * (r.ndim - 1)
    d = r.clone()
    d[:L] -= p_col.reshape((L,) + batch_dims)
    d = carry(d)
    out = torch.where(d[L] >= 0, d[:L], r[:L])
    return out.to(torch.int32)


def redc(F, T: torch.Tensor) -> torch.Tensor:
    """value(T) * R^-1 mod p for int64 product columns T (2L rows of 16-bit
    weight, each in [0, 2^40); value(T) < p * R), as int32 canonical limbs:
    m = (T mod R) n' mod R, then U = T + m p is a multiple of R, U / R < 2p,
    and one conditional subtraction.  The products with the constants n'
    and p are float64 matrix products, exact below 2^53."""
    L = F.L
    batch = tuple(T.shape[1:])
    T = T.reshape(T.shape[0], -1)
    p_col, n_mat, p_mat = _consts(F, T.device)
    # T mod R with 17-bit digits (one pass moving bits 16-31 and 32-39 up)
    low = T[:L]
    w = low & LIMB_MASK
    w[1:] += (low[:-1] >> LIMB_BITS) & LIMB_MASK
    w[2:] += low[:-2] >> (2 * LIMB_BITS)
    m = carry((n_mat @ w.to(torch.float64)).to(torch.int64), wrap=True,
              wide=True)
    U = _rows(T, 2 * L + 1)
    U[:2 * L] += (p_mat @ m.to(torch.float64)).to(torch.int64)
    # The low half of U sums to an exact multiple of R, so carrying it digit
    # by digit would ripple through all L rows.  Its carry into row L is
    # value(U[:L]) / R, and the rows below L-3 add less than 2^-24 to that
    # quotient: it is the ceiling of the top three rows' share.
    a = U[L - 3] + (U[L - 2] << LIMB_BITS)
    top = U[L - 1] - ((-a) >> (2 * LIMB_BITS))
    hi = U[L:].clone()
    hi[0] -= (-top) >> LIMB_BITS
    return cond_sub_p(F, carry(hi, wide=True)).reshape((L,) + batch)


def mont_reduce_rows(F, t: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce an int64 (K <= 2L+2, *batch) accumulator of 16-bit
    weight rows: value(t) * R^-1 mod p, exact for value(t) < p * R (as the
    reference's reduction is), where the carried digits above 2L are 0."""
    digits = carry(_rows(t.to(torch.int64), 2 * F.L + 3), wide=True)
    return redc(F, digits[:2 * F.L])


def mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p with broadcasting over the batch
    (the plain twin of kernel K1)."""
    return redc(F, _antidiag(a.to(torch.int64), b.to(torch.int64), 2 * F.L))


def mont_reduce_wide_plain(F, t: torch.Tensor) -> torch.Tensor:
    """value(t) * R^-1 mod p of a lazy int64 limb accumulator t (K <= 2L+2
    rows of 16-bit weight, columns summed without carries), canonical L
    limbs (the plain twin of kernel K6)."""
    assert t.shape[0] <= 2 * F.L + 2, t.shape[0]
    return mont_reduce_rows(F, t)


def lazy_sum_reduce_plain(F, t: torch.Tensor) -> torch.Tensor:
    """Montgomery form of the sum behind a lazy int64 limb sum t, i.e.
    value(t) mod p (the plain twin of kernel K6)."""
    return mul_plain(F, mont_reduce_wide_plain(F, t),
                     F.r2_limbs(t.device, t.ndim))


def add_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p with broadcasting (the plain twin of kernel K5)."""
    s = a.to(torch.int64) + b.to(torch.int64)
    return cond_sub_p(F, carry(_rows(s, F.L + 1)))


def sub_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p as a + p - b, with broadcasting (the plain twin of
    kernel K5)."""
    L = F.L
    p_col = _consts(F, a.device)[0]
    d = a.to(torch.int64) - b.to(torch.int64)
    d = d + p_col.reshape((L,) + (1,) * (d.ndim - 1))
    return cond_sub_p(F, carry(_rows(d, L + 1)))
