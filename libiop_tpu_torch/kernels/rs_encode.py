"""K14: batched Reed-Solomon row encode wrapper (csrc/rs_encode.cu) and its
plain twin."""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..algebra.domains import bitrev_permutation
from ..fields.limbs import mul_plain
from .ntt import ntt_stage_plain

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

#: shared memory one block of the kernel may take on the H100 (227 KB)
MAX_SHARED_BYTES = 232448


def _stages_plain(F, x, W, n: int, first: int):
    m = first
    while m < n:
        x = ntt_stage_plain(F, x, W, m)
        m *= 2
    return x


def _split(F, src, dst) -> int:
    """e with |dst| = 2^e |src| and g_dst^(2^e) = g_src, or raise."""
    m, N = src.order, dst.order
    if N % m or (N // m) & (N // m - 1) or pow(dst.g, N // m, F.p) != src.g:
        raise ValueError(f"rs_encode: the codeword domain (order {N}) does "
                         f"not contain the source subgroup (order {m}) as "
                         "the powers of its generator")
    return (N // m).bit_length() - 1


def rs_encode_plain(F, values: torch.Tensor, src, dst) -> torch.Tensor:
    """The port's ifft over src then fft over dst (algebra/fft.py), with
    the plain butterfly stages and products."""
    m, N = src.order, dst.order
    dev = values.device
    rev = torch.from_numpy(bitrev_permutation(m)).to(dev)
    x = _stages_plain(F, values.index_select(-1, rev).contiguous(),
                      src.inverse_generator_powers(dev), m, 1)
    x = mul_plain(F, x, F.scalar(pow(m, F.p - 2, F.p), x))
    if src.shift != 1:
        x = mul_plain(F, x, src.inverse_shift_powers(dev)[:, None, :m])
    if dst.shift != 1:
        x = mul_plain(F, x, dst.shift_powers(dev)[:, None, :m])
    x = x.index_select(-1, rev)
    if N > m:
        x = torch.repeat_interleave(x, N // m, dim=-1)
    return _stages_plain(F, x.contiguous(), dst.generator_powers(dev), N,
                         N // m)


def rs_encode(F, values: torch.Tensor, src, dst) -> torch.Tensor:
    """(L, R, |dst|) evaluations over the coset ``dst`` of the polynomials
    whose values on the subgroup ``src`` are the rows of values (L, R,
    |src|).  dst's generator must reach src's in 2^e squarings, |dst| =
    2^e |src|.  CUDA tensors launch K14 once; CPU tensors run the plain
    twin."""
    check_limbs("rs_encode(values)", values)
    if values.ndim != 3 or values.shape[0] != F.L \
            or values.shape[2] != src.order:
        raise ValueError(f"rs_encode: expected ({F.L}, rows, {src.order}) "
                         f"values, got {tuple(values.shape)}")
    e = _split(F, src, dst)
    if values.device.type == "cpu":
        return rs_encode_plain(F, values, src, dst)
    m, N = src.order, dst.order
    if m * 2 * F.L > MAX_SHARED_BYTES:
        raise ValueError(f"rs_encode: a source of {m} elements needs "
                         f"{m * 2 * F.L} B of shared memory; a block has "
                         f"{MAX_SHARED_BYTES}")
    dev = values.device
    rows = values.shape[1]
    out = torch.empty((F.L, rows, N), dtype=torch.int32, device=dev)
    inv_m = F.scalar(pow(m, F.p - 2, F.p), values)
    sinv = src.inverse_shift_powers(dev) if src.shift != 1 else None
    spow = dst.shift_powers(dev) if dst.shift != 1 else None
    fn = build.launcher("rs_encode", "rs_encode_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(values), ptr(src.inverse_generator_powers(dev)),
             ptr(inv_m),
             None if sinv is None else ptr(sinv),
             ptr(dst.generator_powers(dev)),
             None if spow is None else ptr(spow), rows, m, e,
             field_words(F), F.kernel_params(), stream_ptr(dev))
    raise_on_error("rs_encode", err)
    LAUNCHES["rs_encode"] += 1
    return out
