"""K19: additive FRI fold wrapper (csrc/fri_fold_additive.cu), its plain
twin, and a PyTorch model of the kernel's block batch inversion."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from ..fields.binary import xor_reduce
from .gf2k_mul import gf2k_inv_plain, gf2k_mul_plain

#: the kernel's block: THREADS threads of PER positions (Montgomery's trick
#: over BLOCK positions, one inversion a block)
THREADS, PER = 128, 16
BLOCK = THREADS * PER

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


def fri_fold_additive_block_model(F, evals, elems, offsets, x: int,
                                  zv_x: int, eps_inv: int,
                                  c: int) -> torch.Tensor:
    """The kernel's steps in PyTorch, every block at once: position
    b BLOCK + k THREADS + t belongs to thread t of block b.  Each thread's
    exclusive prefix products of D = x ^ e (a zero D and a position past N
    as 1), the block's scans of the threads' products both ways, one
    inversion a block, the walk back (D^-1 = inv prefix_k, inv *= D), the
    terms f(e) D^-1 (f(e) itself where D = 0), and per coset their XOR
    times eps^-1 (Z_V(x) + offset_j), or the member's f(e)."""
    W, N = evals.shape
    nc, nb = N // c, -(-N // BLOCK)
    dev = evals.device
    one = F.from_ints([1], dev).reshape(W, 1)
    D = elems ^ F.from_ints([x], dev).reshape(W, 1)
    member = (D == 0).all(dim=0)
    D = torch.where(member[None, :], one, D)
    D = torch.cat([D, one.expand(W, nb * BLOCK - N)], dim=1)
    D = D.reshape(W, nb, PER, THREADS)

    # 1. each thread's exclusive prefixes and its running product
    run = one.reshape(W, 1, 1).expand(W, nb, THREADS).contiguous()
    prefix = []
    for k in range(PER):
        prefix.append(run)
        run = gf2k_mul_plain(F, run, D[:, :, k])
    # 2. inclusive scans of the threads' products, both ways
    pre, suf = run.clone(), run.clone()
    d = 1
    while d < THREADS:
        pre_new, suf_new = pre.clone(), suf.clone()
        pre_new[..., d:] = gf2k_mul_plain(F, pre[..., d:], pre[..., :-d])
        suf_new[..., :-d] = gf2k_mul_plain(F, suf[..., :-d], suf[..., d:])
        pre, suf, d = pre_new, suf_new, 2 * d
    # 3. one inversion a block; each thread's share of it
    inv = gf2k_inv_plain(F, pre[..., -1:]).expand(W, nb, THREADS).clone()
    inv[..., 1:] = gf2k_mul_plain(F, inv[..., 1:], pre[..., :-1])
    inv[..., :-1] = gf2k_mul_plain(F, inv[..., :-1], suf[..., 1:])
    # 4. the walk back
    dinv = [None] * PER
    for k in range(PER - 1, -1, -1):
        dinv[k] = gf2k_mul_plain(F, inv, prefix[k])
        inv = gf2k_mul_plain(F, inv, D[:, :, k])
    dinv = torch.stack(dinv, dim=2).reshape(W, nb * BLOCK)[:, :N]
    terms = torch.where(member[None, :], evals,
                        gf2k_mul_plain(F, dinv, evals)).reshape(W, nc, c)
    # 5. a coset
    is_member = member.reshape(nc, c)
    acc = xor_reduce(torch.where(is_member[None], 0, terms))
    sel = xor_reduce(torch.where(is_member[None], terms, 0))
    scale = gf2k_mul_plain(F, offsets ^ F.from_ints([zv_x], dev).reshape(W, 1),
                           F.from_ints([eps_inv], dev).reshape(W, 1))
    return torch.where(is_member.any(dim=-1)[None, :], sel,
                       gf2k_mul_plain(F, acc, scale))


def fri_fold_additive(F, evals: torch.Tensor, elems: torch.Tensor,
                      offsets: torch.Tensor, x: int, zv_x: int, eps_inv: int,
                      c: int) -> torch.Tensor:
    """Fold a (W, N) codeword over contiguous cosets of c = 2^eta into
    (W, N/c) at the challenge x, given the domain's elements (W, N), the
    per-coset offsets Z_V(shift_j) (W, N/c), Z_V(x) and eps^-1 (ints),
    c <= BLOCK.  CUDA tensors launch K19 (a batch inversion a block of
    BLOCK positions); CPU tensors run the plain twin."""
    for name, t in (("evals", evals), ("elems", elems),
                    ("offsets", offsets)):
        check_limbs(f"fri_fold_additive({name})", t, evals.device)
    W, N = evals.shape
    if W != F.W or c < 1 or c & (c - 1) or c > BLOCK or N % c \
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
