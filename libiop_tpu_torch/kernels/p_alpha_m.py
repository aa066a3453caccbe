"""K21: the holographic lincheck's p_alpha * M product (csrc/p_alpha_m.cu)
and its plain twins, over a prime field (Montgomery limbs) or GF(2^k)
(words, XOR sums)."""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words, ptr,
               raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, lazy_sum_reduce_plain, mul_plain
from .gf2k_mul import gf2k_mul_plain
from .place_columns import place_columns_plain
from .row_dot import accumulator_cap

MAX_MATS = 4
#: nonzeros a lane of K21 takes in the densest column before the wrapper
#: gives each slot more lanes
LANE_NNZ = 16
#: (vals (L, nnz), offsets (S + 1,), src (nnz,), kmax): M^T in CSR form on
#: the device, values by column, kmax the densest column's count
#: (relations/sparse.py transpose_csr_device)
Plan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]


class _Matrix(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p), ("nvals", ctypes.c_longlong),
                ("offsets", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("r", ctypes.c_uint32 * 8)]


class _Args(ctypes.Structure):
    _fields_ = [("m", _Matrix * MAX_MATS), ("n_mats", ctypes.c_int),
                ("p", ctypes.c_void_p), ("np", ctypes.c_longlong),
                ("inv", ctypes.c_void_p), ("S", ctypes.c_longlong),
                ("nv", ctypes.c_longlong), ("cap", ctypes.c_int),
                ("group", ctypes.c_int), ("r_mod_p", ctypes.c_void_p)]


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def p_alpha_m_plain(F, plans: Sequence[Plan], p: torch.Tensor,
                    r_ints: List[int], inv: torch.Tensor, S: int
                    ) -> torch.Tensor:
    """The reference's composition: a transpose matvec a matrix (products
    summed lazily per column, reduced once), the product by r_M, the sum,
    then the placement through inv."""
    acc = None
    cols = torch.arange(S, device=p.device)
    for (vals, offsets, src, _), r in zip(plans, r_ints):
        prod = mul_plain(F, vals, p.index_select(1, src))
        lazy = torch.zeros((F.L, S), dtype=torch.int64, device=p.device)
        lazy.index_add_(1, torch.repeat_interleave(cols, offsets.diff()),
                        prod.to(torch.int64))
        term = mul_plain(F, lazy_sum_reduce_plain(F, lazy),
                         F.from_ints([r], p.device).reshape(F.L, 1))
        acc = term if acc is None else add_plain(F, acc, term)
    return place_columns_plain(acc, inv)


def p_alpha_m_gf2_plain(F, plans: Sequence[Plan], p: torch.Tensor,
                        r_ints: List[int], inv: torch.Tensor, S: int
                        ) -> torch.Tensor:
    """The same composition over GF(2^k): per matrix the products XORed
    per column (a parity of bit-plane counts), the product by r_M, the XOR
    over the matrices, then the placement."""
    acc = F.zeros((S,), p.device)
    cols = torch.arange(S, device=p.device)
    shifts = torch.arange(32, dtype=torch.int64, device=p.device)
    for (vals, offsets, src, _), r in zip(plans, r_ints):
        prod = gf2k_mul_plain(F, vals, p.index_select(1, src))
        bits = (prod.to(torch.int64)[:, None, :] >> shifts[None, :, None]) & 1
        counts = torch.zeros((F.W * 32, S), dtype=torch.int64,
                             device=p.device)
        counts.index_add_(1, torch.repeat_interleave(cols, offsets.diff()),
                          bits.reshape(F.W * 32, -1))
        words = ((counts & 1).reshape(F.W, 32, S)
                 << shifts[None, :, None]).sum(dim=1)
        col_sums = (words - ((words >> 31) << 32)).to(torch.int32)
        acc ^= gf2k_mul_plain(F, col_sums, F.from_ints([r], p.device))
    return place_columns_plain(acc, inv)


def group_size(plans: Sequence[Plan]) -> int:
    """K21's lanes a slot: a power of two <= 32 that leaves a lane at most
    LANE_NNZ nonzeros of the densest column where it can."""
    kmax = max(plan[3] for plan in plans)
    G = 1
    while G < 32 and G * LANE_NNZ < kmax:
        G *= 2
    return G


def p_alpha_m(F, plans: Sequence[Plan], p: torch.Tensor, r_ints: List[int],
              inv: torch.Tensor, S: int) -> torch.Tensor:
    """(L, len(inv)) out[:, c] = sum_M r_M (M^T p)[:, inv[c]], zero where
    inv[c] == S, for the matrices' M^T in CSR form (S columns), p (L, np)
    Montgomery limbs or GF(2^k) words and canonical ints r_M.  CUDA tensors
    launch K21 (its GF(2^k) instantiation for a binary field); CPU tensors
    run the plain twin."""
    check_limbs("p_alpha_m(p)", p)
    dev = p.device
    if not 1 <= len(plans) <= MAX_MATS or len(r_ints) != len(plans) \
            or p.ndim != 2 or p.shape[0] != F.L:
        raise ValueError(f"p_alpha_m: {len(plans)} plans, {len(r_ints)} "
                         f"coefficients, p {tuple(p.shape)}")
    for vals, offsets, src, _ in plans:
        check_limbs("p_alpha_m(vals)", vals, dev)
        for t, n in ((offsets, S + 1), (src, vals.shape[1])):
            if t.dtype != torch.int64 or not t.is_contiguous() \
                    or t.device != dev or t.numel() != n:
                raise ValueError("p_alpha_m: plan arrays must be contiguous "
                                 "int64 (S + 1 offsets, one src a nonzero) "
                                 f"on {dev}")
    if inv.dtype != torch.int64 or inv.ndim != 1 or not inv.is_contiguous() \
            or inv.device != dev:
        raise ValueError("p_alpha_m: inv must be a contiguous 1-D int64 "
                         f"tensor on {dev}")
    binary = F.kind == "additive"
    if dev.type == "cpu":
        return (p_alpha_m_gf2_plain if binary else p_alpha_m_plain)(
            F, plans, p, r_ints, inv, S)
    nv = inv.shape[0]
    out = torch.empty((F.L, nv), dtype=torch.int32, device=dev)
    args = _Args()
    for k, ((vals, offsets, src, _), r) in enumerate(zip(plans, r_ints)):
        m = args.m[k]
        m.vals, m.nvals = vals.data_ptr(), vals.shape[1]
        m.offsets, m.src = offsets.data_ptr(), src.data_ptr()
        word_bits = F.sample_int(int(r)) if binary else \
            (int(r) % F.p) * F.R % F.p
        for j in range(F.W if binary else F.L // 2):
            m.r[j] = (word_bits >> (32 * j)) & 0xffffffff
    args.n_mats = len(plans)
    args.p, args.np = p.data_ptr(), p.shape[1]
    args.inv, args.S, args.nv = inv.data_ptr(), S, nv
    args.group = group_size(plans)
    if binary:
        fn = build.launcher("p_alpha_m", "p_alpha_m_gf2_launch", _ARGTYPES)
        err = fn(ptr(out), ctypes.byref(args), binary_words(F),
                 F.kernel_params(), stream_ptr(dev))
        raise_on_error("p_alpha_m", err)
        LAUNCHES["p_alpha_m_gf2"] += 1
        return out
    args.cap = accumulator_cap(F)
    r_mod_p = F.ones((1,), dev)  # 2^(32W) mod p, the fold's factor
    args.r_mod_p = r_mod_p.data_ptr()
    fn = build.launcher("p_alpha_m", "p_alpha_m_launch", _ARGTYPES)
    err = fn(ptr(out), ctypes.byref(args), field_words(F), F.kernel_params(),
             stream_ptr(dev))
    raise_on_error("p_alpha_m", err)
    LAUNCHES["p_alpha_m"] += 1
    return out
