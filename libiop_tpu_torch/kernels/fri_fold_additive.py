"""K19: additive FRI fold wrapper (csrc/fri_fold_additive.cu) and its plain
twin."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from ..fields.binary import xor_reduce
from .gf2k_mul import gf2k_inv_plain, gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int] + [ctypes.c_void_p] * 3


def fri_fold_additive_plain(F, evals, elems, offsets, x: int, zv_x: int,
                            eps_inv: int, c: int) -> torch.Tensor:
    """The reference's fold (fri.py:240-266): per coset the XOR of
    f(e) (x - e)^-1 times eps^-1 (Z_V(x) + offset_j), or f(e) where x = e."""
    W, N = evals.shape
    nc = N // c
    dev = evals.device
    xs = F.from_ints([x], dev).reshape(W, 1)
    D = elems ^ xs
    member = (D == 0).all(dim=0)
    terms = gf2k_mul_plain(F, evals, gf2k_inv_plain(F, D)).reshape(W, nc, c)
    scale = gf2k_mul_plain(F, offsets ^ F.from_ints([zv_x], dev).reshape(W, 1),
                           F.from_ints([eps_inv], dev).reshape(W, 1))
    lagrange = gf2k_mul_plain(F, xor_reduce(terms), scale)
    sel = xor_reduce(torch.where(member[None, :], evals,
                                 torch.zeros_like(evals)).reshape(W, nc, c))
    has = member.reshape(nc, c).any(dim=-1)
    return torch.where(has[None, :], sel, lagrange)


def fri_fold_additive(F, evals: torch.Tensor, elems: torch.Tensor,
                      offsets: torch.Tensor, x: int, zv_x: int, eps_inv: int,
                      c: int) -> torch.Tensor:
    """Fold a (W, N) codeword over contiguous cosets of c = 2^eta into
    (W, N/c) at the challenge x, given the domain's elements (W, N), the
    per-coset offsets Z_V(shift_j) (W, N/c), Z_V(x) and eps^-1 (ints).
    CUDA tensors launch K19; CPU tensors run the plain twin."""
    for name, t in (("evals", evals), ("elems", elems),
                    ("offsets", offsets)):
        check_limbs(f"fri_fold_additive({name})", t, evals.device)
    W, N = evals.shape
    if W != F.W or c < 1 or c & (c - 1) or N % c \
            or tuple(elems.shape) != (W, N) \
            or tuple(offsets.shape) != (W, N // c):
        raise ValueError(f"fri_fold_additive: bad shapes evals "
                         f"{tuple(evals.shape)}, c = {c}")
    if evals.device.type == "cpu":
        return fri_fold_additive_plain(F, evals, elems, offsets, x, zv_x,
                                       eps_inv, c)
    out = torch.empty((W, N // c), dtype=torch.int32, device=evals.device)
    scalars = (ctypes.c_uint32 * (3 * W))(*[
        (v >> (32 * w)) & 0xFFFFFFFF for v in (x, zv_x, eps_inv)
        for w in range(W)])
    fn = build.launcher("fri_fold_additive", "fri_fold_additive_launch",
                        _ARGTYPES)
    err = fn(ptr(out), ptr(evals), ptr(elems), ptr(offsets), N, c,
             binary_words(F), scalars, F.kernel_params(),
             stream_ptr(evals.device))
    raise_on_error("fri_fold_additive", err)
    LAUNCHES["fri_fold_additive"] += 1
    return out
