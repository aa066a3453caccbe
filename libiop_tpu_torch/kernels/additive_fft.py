"""K17: additive FFT / IFFT wrapper (csrc/additive_fft.cu) and its plain
twin, over flat per-level tables built by algebra/subspace.py.

Tables: ``tw`` (W, 2n - 2) holds the twist powers of level j (beta_j^r,
r < n >> j; their inverses for the IFFT) at offset 2n - 2(n >> j); ``sums``
(W, n - 1) holds the unwind subset sums of level j (2^j of them) at offset
2^j - 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from ..algebra.domains import bitrev_permutation
from .gf2k_mul import gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def twist_level(tw: torch.Tensor, n: int, j: int) -> torch.Tensor:
    off = 2 * n - 2 * (n >> j)
    return tw[:, off:off + (n >> j)]


def sums_level(sums: torch.Tensor, j: int) -> torch.Tensor:
    return sums[:, (1 << j) - 1:(1 << (j + 1)) - 1]


def additive_fft_plain(F, S: torch.Tensor, tw: torch.Tensor,
                       sums: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The reference's levels (subspace.py:172-211 forward, :220-255
    inverse) on a (W, n) or (W, R, n) tensor (R transforms) with the flat
    tables."""
    shape = S.shape
    W, n = shape[0], shape[-1]
    S = S.reshape(W, -1, n)
    R = S.shape[1]
    m = n.bit_length() - 1
    rev = torch.from_numpy(bitrev_permutation(n)).to(S.device)

    def twist(S, j):
        rows = n >> j
        return gf2k_mul_plain(F, S.reshape(W, R, rows, 1 << j),
                              twist_level(tw, n, j)[:, None, :, None]
                              ).reshape(W, R, n)

    def radix(S, stride):
        B = S.reshape(W, R, -1, 4, stride).clone()
        if inverse:
            B[:, :, :, 1] ^= B[:, :, :, 2]
            B[:, :, :, 2] ^= B[:, :, :, 3]
        else:
            B[:, :, :, 2] ^= B[:, :, :, 3]
            B[:, :, :, 1] ^= B[:, :, :, 2]
        return B.reshape(W, R, n)

    def unwind(S, j):
        B = S.reshape(W, R, -1, 2, 1 << j)
        z = sums_level(sums, j)[:, None, None, :]
        if inverse:
            hi = B[:, :, :, 1] ^ B[:, :, :, 0]
            lo = B[:, :, :, 0] ^ gf2k_mul_plain(F, hi, z)
        else:
            lo = B[:, :, :, 0] ^ gf2k_mul_plain(F, B[:, :, :, 1], z)
            hi = B[:, :, :, 1] ^ lo
        return torch.stack([lo, hi], dim=3).reshape(W, R, n)

    if not inverse:
        for j in range(m):
            S = twist(S, j)
            stride = n // 4
            while stride >= (1 << j) and stride > 0:
                S = radix(S, stride)
                stride >>= 1
        S = S.index_select(2, rev)
        for j in range(m):
            S = unwind(S, j)
        return S.reshape(shape)
    for j in range(m - 1, -1, -1):
        S = unwind(S, j)
    S = S.index_select(2, rev)
    for j in range(m - 1, -1, -1):
        stride = 1 << j
        while stride <= n // 4:
            S = radix(S, stride)
            stride <<= 1
        S = twist(S, j)
    return S.reshape(shape)


def additive_fft(F, S: torch.Tensor, tw: torch.Tensor, sums: torch.Tensor,
                 inverse: bool = False) -> torch.Tensor:
    """Additive FFT (or IFFT) of the (W, n) words S, n = 2^m, natural order
    in and out, or of each of the R rows of (W, R, n) words over the same
    domain.  CUDA tensors launch K17 (one kernel a twist level, radix
    stride, unwind level and the bit reversal, whatever R); CPU tensors run
    the plain twin."""
    for name, t in (("S", S), ("tw", tw), ("sums", sums)):
        check_limbs(f"additive_fft({name})", t, S.device)
    W, n = S.shape[0], S.shape[-1]
    if S.ndim not in (2, 3) or W != F.W or n & (n - 1) \
            or tuple(tw.shape) != (W, max(2 * n - 2, 0)) \
            or tuple(sums.shape) != (W, n - 1):
        raise ValueError(f"additive_fft: bad shapes S {tuple(S.shape)}, "
                         f"tw {tuple(tw.shape)}, sums {tuple(sums.shape)}")
    if S.device.type == "cpu":
        return additive_fft_plain(F, S, tw, sums, inverse)
    if n == 1:
        return S.clone()
    work = S.clone()
    out = torch.empty_like(S)
    count = ctypes.c_int(0)
    fn = build.launcher("additive_fft", "additive_fft_launch", _ARGTYPES)
    rows = S.shape[1] if S.ndim == 3 else 1
    err = fn(ptr(work), ptr(out), ptr(tw), ptr(sums), n.bit_length() - 1,
             rows, int(inverse), binary_words(F), F.kernel_params(),
             stream_ptr(S.device), ctypes.byref(count))
    raise_on_error("additive_fft", err)
    LAUNCHES["additive_fft"] += count.value
    return out
