"""K7: padded-ELL sparse matvec wrapper (csrc/ell_matvec.cu) and its plain
twins, over a prime field (Montgomery limbs) or GF(2^k) (words, an XOR
sum)."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.binary import xor_reduce
from ..fields.limbs import lazy_sum_reduce_plain, mul_plain
from .gf2k_mul import gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + \
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def ell_matvec_plain(F, vals_pad, entry, src, vec, K: int) -> torch.Tensor:
    """Gather, multiply, sum each row's K products lazily in int64 and
    reduce once (the reference's _ell_apply)."""
    S = entry.numel() // K
    prod = mul_plain(F, vals_pad.index_select(1, entry),
                     vec.index_select(1, src))
    return lazy_sum_reduce_plain(
        F, prod.reshape(F.L, S, K).to(torch.int64).sum(-1))


def ell_matvec_gf2_plain(F, vals_pad, entry, src, vec, K: int
                         ) -> torch.Tensor:
    """Gather, multiply and XOR each row's K products (the reference's
    _ell_apply over GF(2^k))."""
    S = entry.numel() // K
    prod = gf2k_mul_plain(F, vals_pad.index_select(1, entry),
                          vec.index_select(1, src))
    return xor_reduce(prod.reshape(F.W, S, K), dim=2)


def ell_matvec(F, vals_pad: torch.Tensor, entry: torch.Tensor,
               src: torch.Tensor, vec: torch.Tensor, K: int) -> torch.Tensor:
    """out[:, s] = sum_k vals_pad[:, entry[s*K+k]] * vec[:, src[s*K+k]]
    (mod p, or over GF(2^k)) for the (S*K,) int64 plan arrays; vals_pad
    (L, nnz+1) ends with the zero column that padding slots point at.  CUDA
    tensors launch K7 (its GF(2^k) instantiation for a binary field); CPU
    tensors run the plain twin."""
    check_limbs("ell_matvec(vals_pad)", vals_pad)
    check_limbs("ell_matvec(vec)", vec, vals_pad.device)
    for name, t in (("entry", entry), ("src", src)):
        if t.dtype != torch.int64 or not t.is_contiguous() \
                or t.device != vals_pad.device:
            raise ValueError(f"ell_matvec({name}): expected a contiguous "
                             f"int64 tensor on {vals_pad.device}")
    if vals_pad.shape[0] != F.L or vec.shape[0] != F.L or vals_pad.ndim != 2 \
            or vec.ndim != 2 or K < 1 or entry.numel() % K \
            or src.numel() != entry.numel():
        raise ValueError(f"ell_matvec: bad shapes vals={tuple(vals_pad.shape)} "
                         f"vec={tuple(vec.shape)} plan={entry.numel()} K={K}")
    binary = F.kind == "additive"
    if vals_pad.device.type == "cpu":
        return (ell_matvec_gf2_plain if binary else ell_matvec_plain)(
            F, vals_pad, entry, src, vec, K)
    S = entry.numel() // K
    out = torch.empty((F.L, S), dtype=torch.int32, device=vals_pad.device)
    if binary:
        fn = build.launcher("ell_matvec", "ell_matvec_gf2_launch", _ARGTYPES)
        err = fn(ptr(out), ptr(vals_pad), vals_pad.shape[1], ptr(entry),
                 ptr(src), ptr(vec), vec.shape[1], S, K, binary_words(F),
                 F.kernel_params(), stream_ptr(vals_pad.device))
        raise_on_error("ell_matvec", err)
        LAUNCHES["ell_matvec_gf2"] += 1
        return out
    fn = build.launcher("ell_matvec", "ell_matvec_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(vals_pad), vals_pad.shape[1], ptr(entry), ptr(src),
             ptr(vec), vec.shape[1], S, K, field_words(F), F.kernel_params(),
             stream_ptr(vals_pad.device))
    raise_on_error("ell_matvec", err)
    LAUNCHES["ell_matvec"] += 1
    return out
