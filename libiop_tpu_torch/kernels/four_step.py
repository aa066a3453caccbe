"""K23: the four-step NTT's data movement (csrc/four_step.cu) and its plain
twins.

``parallel/shard_ntt.py`` evaluates a codeword of N = R * C points as C-point
NTTs over the j1 columns of the grid x[j1 + R * j2], twiddles w^(j1 * k2),
one all-to-all and R-point NTTs; shard s of D holds the j1 columns
[s * R/D, (s + 1) * R/D).  The NTTs are K2's stages; the four passes between
them are this kernel's four launch shapes:

- ``prologue``: coefficients (L, B, d) -> this shard's rows over j2, times
  the coset's shift powers, each row in bit-reversed order: (L, B, R/D, C);
  a coefficient index at or past d reads as zero (the zero padding to N);
- ``twiddle_pack``: the C-point NTTs' output (L, B, R/D, C) times
  w^(j1 * k2) = W[(j1 * k2) mod N], written as the all-to-all's send buffer
  (D, L, B, R/D, C/D) with the chunk of destination shard t at [t];
- ``unpack``: the received (D, L, B, R/D, C/D), source shard first, -> rows
  over j1 = src * R/D + j1_local in bit-reversed order: (L, B, C/D, R);
- ``epilogue``: the gathered (D, L, B, C/D, R) -> the natural-order
  codeword (L, B, N), X[k1 * C + s * C/D + k2].

On the card the prologue and the twiddle carry the Montgomery product (a
32 x 32 tile a block, word planes through shared memory); the unpack and
the epilogue are limb-plane permutations that move the int32 limbs as they
are, one limb plane a grid row and one 32 x 32 tile a block, with 16-byte
loads and stores where C/D and R are multiples of 4 (4-byte accesses
otherwise).  CUDA tensors launch the kernel; CPU tensors run the plain
twins.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..algebra.domains import bitrev_permutation
from ..fields.limbs import mul_plain

PROLOGUE, TWIDDLE, UNPACK, EPILOGUE = 0, 1, 2, 3
_KEYS = {PROLOGUE: "four_step_prologue", TWIDDLE: "four_step_twiddle",
         UNPACK: "four_step_unpack", EPILOGUE: "four_step_epilogue"}

# mode, out, in, table, B, D, R, C, d, s, words, field, stream
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
    [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"four_step: {n} is not a power of two")
    return n.bit_length() - 1


def bitrev(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of range(n) (n a power of two)."""
    _log2(n)
    return torch.from_numpy(bitrev_permutation(n)).to(device)


def _launch(F, mode, out, inp, table, B, D, R, C, d=0, s=0):
    fn = build.launcher("four_step", "four_step_launch", _ARGTYPES)
    err = fn(mode, ptr(out), ptr(inp),
             ctypes.c_void_p(None if table is None else table.data_ptr()),
             B, D, R, C, d, s, field_words(F), F.kernel_params(),
             stream_ptr(out.device))
    raise_on_error(_KEYS[mode], err)
    LAUNCHES[_KEYS[mode]] += 1
    return out


def _check_plan(D, R, C):
    _log2(D), _log2(R), _log2(C)
    if R % D or C % D:
        raise ValueError(f"four_step: D = {D} must divide R = {R} and C = {C}")


# -- the plain twins --------------------------------------------------------
def prologue_plain(F, x, s, D, R, C, shift_powers=None):
    """out[:, b, i, t] = x[:, b, j] * shift_powers[:, j] for
    j = s * R/D + i + R * bitrev_C(t), zero where j >= d."""
    L, B, d = x.shape
    RD = R // D
    j = (s * RD + torch.arange(RD, device=x.device)[:, None]
         + R * bitrev(C, x.device)[None, :])
    valid = j < d
    jc = torch.where(valid, j, torch.zeros_like(j)).reshape(-1)
    out = x.index_select(2, jc).reshape(L, B, RD, C)
    if shift_powers is not None:
        out = mul_plain(F, out, shift_powers.index_select(1, jc).reshape(
            L, 1, RD, C))
    return torch.where(valid, out, torch.zeros_like(out)).contiguous()


def twiddle_pack_plain(F, a, s, D, W):
    """send[t, :, b, i, k] = a[:, b, i, t * C/D + k] * W[:, (j1 * k2) mod N]
    for j1 = s * R/D + i, k2 = t * C/D + k; W is the (L, N) table of
    generator powers."""
    L, B, RD, C = a.shape
    N = W.shape[1]
    j1 = s * RD + torch.arange(RD, device=a.device)
    k2 = torch.arange(C, device=a.device)
    idx = ((j1[:, None] * k2[None, :]) % N).reshape(-1)
    t = mul_plain(F, a, W.index_select(1, idx).reshape(L, 1, RD, C))
    return t.reshape(L, B, RD, D, C // D).permute(3, 0, 1, 2, 4).contiguous()


def unpack_plain(recv, R):
    """out[:, b, k, t] = recv[src, :, b, i, k] where src * R/D + i =
    bitrev_R(t)."""
    D, L, B, RD, CD = recv.shape
    full = recv.permute(1, 2, 0, 3, 4).reshape(L, B, R, CD)
    return full.index_select(2, bitrev(R, recv.device)).transpose(
        2, 3).contiguous()


def epilogue_plain(g, C):
    """out[:, b, k1 * C + s * C/D + k] = g[s, :, b, k, k1]."""
    D, L, B, CD, R = g.shape
    return g.permute(1, 2, 4, 0, 3).reshape(L, B, R * C).contiguous()


# -- the wrappers -----------------------------------------------------------
def prologue(F, x, s, D, R, C, shift_powers=None):
    """Shard s's rows of the four-step grid from coefficients x (L, B, d),
    d <= R * C, times the shift powers (L, R * C) when given."""
    check_limbs("four_step_prologue(x)", x)
    _check_plan(D, R, C)
    L, B, d = x.shape
    if L != F.L or d > R * C or not 0 <= s < D:
        raise ValueError(f"four_step_prologue: bad x {tuple(x.shape)} for "
                         f"R = {R}, C = {C}, shard {s} of {D}")
    if shift_powers is not None:
        check_limbs("four_step_prologue(shift_powers)", shift_powers,
                    x.device)
        if tuple(shift_powers.shape) != (F.L, R * C):
            raise ValueError("four_step_prologue: bad shift_powers "
                             f"{tuple(shift_powers.shape)}")
    if x.device.type == "cpu":
        return prologue_plain(F, x, s, D, R, C, shift_powers)
    out = torch.empty((F.L, B, R // D, C), dtype=torch.int32, device=x.device)
    return _launch(F, PROLOGUE, out, x, shift_powers, B, D, R, C, d, s)


def twiddle_pack(F, a, s, D, W):
    """The all-to-all's send buffer (D, L, B, R/D, C/D) of shard s from the
    C-point NTTs' output a (L, B, R/D, C), times w^(j1 * k2) from the
    (L, N) generator powers W."""
    check_limbs("four_step_twiddle(a)", a)
    check_limbs("four_step_twiddle(W)", W, a.device)
    L, B, RD, C = a.shape
    R = RD * D
    _check_plan(D, R, C)
    if L != F.L or tuple(W.shape) != (F.L, R * C) or not 0 <= s < D:
        raise ValueError(f"four_step_twiddle: bad a {tuple(a.shape)}, W "
                         f"{tuple(W.shape)}, shard {s} of {D}")
    if a.device.type == "cpu":
        return twiddle_pack_plain(F, a, s, D, W)
    out = torch.empty((D, F.L, B, RD, C // D), dtype=torch.int32,
                      device=a.device)
    return _launch(F, TWIDDLE, out, a, W, B, D, R, C, 0, s)


def unpack(F, recv, R):
    """Rows over j1 in bit-reversed order (L, B, C/D, R) from the received
    (D, L, B, R/D, C/D)."""
    check_limbs("four_step_unpack(recv)", recv)
    D, L, B, RD, CD = recv.shape
    _check_plan(D, R, CD * D)
    if L != F.L or RD * D != R:
        raise ValueError(f"four_step_unpack: bad recv {tuple(recv.shape)} "
                         f"for R = {R}")
    if recv.device.type == "cpu":
        return unpack_plain(recv, R)
    out = torch.empty((F.L, B, CD, R), dtype=torch.int32, device=recv.device)
    return _launch(F, UNPACK, out, recv, None, B, D, R, CD * D)


def epilogue(F, g, C):
    """The natural-order codeword (L, B, R * C) from the gathered shards
    (D, L, B, C/D, R)."""
    check_limbs("four_step_epilogue(g)", g)
    D, L, B, CD, R = g.shape
    _check_plan(D, R, C)
    if L != F.L or CD * D != C:
        raise ValueError(f"four_step_epilogue: bad g {tuple(g.shape)} for "
                         f"C = {C}")
    if g.device.type == "cpu":
        return epilogue_plain(g, C)
    out = torch.empty((F.L, B, R * C), dtype=torch.int32, device=g.device)
    return _launch(F, EPILOGUE, out, g, None, B, D, R, C)
