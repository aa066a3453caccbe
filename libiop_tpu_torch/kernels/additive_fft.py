"""K17: additive FFT / IFFT wrapper (csrc/additive_fft.cu), its pass plan,
a PyTorch model of the passes and the plain twin, over flat per-level
tables built by algebra/subspace.py.

Tables: ``tw`` (W, 2n - 2) holds the twist powers of level j (beta_j^r,
r < n >> j; their inverses for the IFFT) at offset 2n - 2(n >> j); ``sums``
(W, n - 1) holds the unwind subset sums of level j (2^j of them) at offset
2^j - 1.

The pass plan.  The reference's forward transform over n = 2^m is, per
level j, a twist (element i times tw_j[i >> j]) and radix steps at strides
2^b, b = m-2 down to j (groups of four over index bits b and b + 1), then a
bit reversal and unwind levels j = 0 .. m-1 (pairs over bit j of the
output index).  A pass is one launch in which a block loads the elements
whose index bits outside a set of "inside" bits are fixed, runs a list of
those steps on them in shared memory, and stores them.  The inside bits are
a low run [0, low) (neighbouring elements, for whole memory sectors) and a
window [lo, lo + win).  Steps only ever mix inside bits:
- levels j >= j0 touch only bits >= j0 (the twist reads i >> j, the radix
  groups sit at strides >= 2^j), so one *class pass* over the window
  [j0, m) runs all of them, and then the first m - j0 unwind levels, which
  mix bits m-1-j of the same index once the bit reversal is read into
  them;
- an earlier level j < j0 takes a *column pass* (its twist and its radix
  steps over the high bits) and a *tile pass* (its radix steps over a
  contiguous run of low bits), more column passes where the array is too
  large for two;
- the last j0 unwind levels run in the output order ("o" space) in a
  *final pass*, which loads through the bit reversal.
The inverse runs the passes in reverse order, each step inverted, with the
inverse twist table.  ``additive_fft_plan`` gives the passes; the C
launcher runs exactly those it is handed, and ``additive_fft_passes_model``
runs them in PyTorch, a block a row of a gathered tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from ..algebra.domains import bitrev_permutation
from .gf2k_mul import gf2k_mul_plain

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int] + \
    [ctypes.c_void_p] * 2

#: step kinds as the kernel encodes them (kind << 8 | argument)
_KIND = {"twist": 0, "radix": 1, "unwind": 2}
#: steps a pass may hold (csrc/additive_fft.cu kMaxOps)
MAX_OPS = 128
#: shared memory a block of the pass kernel may take (of the H100's 227 KB;
#: the launcher asks for what the plan's largest block needs)
SMEM_BYTES = 200 * 1024


class AfftPass(NamedTuple):
    """One launch: inside bits [0, low) and [lo, lo + win) of the index in
    ``space`` ("i": the radix order, before the bit reversal; "o": the
    output order); the global position of index p is p, or its m-bit
    reversal where load_rev / store_rev says so; ``ops`` the steps, each
    ("twist", j), ("radix", b) or ("unwind", j), in the order they run."""
    space: str
    low: int
    lo: int
    win: int
    load_rev: bool
    store_rev: bool
    ops: Tuple[Tuple[str, int], ...]

    @property
    def bits(self) -> int:
        return self.low + self.win

    def local_bit(self, bit: int) -> int:
        """The position of index bit ``bit`` in a block's local index."""
        if bit < self.low:
            return bit
        if self.lo <= bit < self.lo + self.win:
            return self.low + bit - self.lo
        raise ValueError(f"bit {bit} is not inside {self}")


def block_bits(m: int, W: int) -> int:
    """log2 of the elements a block holds: the whole transform up to 2^8,
    else enough blocks for the card (n / 2^7 a block, at least 2^8) up to
    what shared memory holds (2^13 elements of W <= 6 words, 2^12 of 8)."""
    cap = 13 if (4 * W) << 13 <= SMEM_BYTES else 12
    return min(m, cap, max(8, m - 7))


def coalesce_bits(B: int) -> int:
    """The low run of a column or class pass: 8 neighbouring elements (a
    32-byte sector a word) once a block holds 2^13, 4 from 2^11; none
    below, where the run would cost the launches of more passes."""
    return 3 if B >= 13 else 2 if B >= 11 else 0


def additive_fft_plan(m: int, W: int, block: Optional[int] = None,
                      coalesce: Optional[int] = None) -> Tuple[AfftPass, ...]:
    """The forward transform over 2^m as passes (``block`` and
    ``coalesce`` override block_bits and coalesce_bits)."""
    B = block_bits(m, W) if block is None else block
    c = coalesce_bits(B) if coalesce is None else coalesce
    if m == 0:
        return ()
    if m <= B:
        ops = []
        for j in range(m):
            ops += [("twist", j)] + [("radix", b)
                                     for b in range(m - 2, j - 1, -1)]
        ops += [("unwind", j) for j in range(m)]
        return (AfftPass("i", m, m, 0, False, True, tuple(ops)),)
    if not 0 <= c < B - 1:
        raise ValueError(f"additive_fft_plan: low run {c} for blocks of "
                         f"2^{B}")
    passes = []
    j0 = m - (B - c)
    for j in range(j0):
        # level j: its twist, then radix steps b = m-2 .. j over bits j .. m-1
        hi, first = m - 1, True
        while True:
            twist = (("twist", j),) if first else ()
            first = False
            if hi + 1 <= B:
                passes.append(AfftPass("i", hi + 1, hi + 1, 0, False, False,
                                       twist + tuple(("radix", b) for b in
                                                     range(hi - 1, j - 1,
                                                           -1))))
                break
            lo = max(j, hi + 1 - (B - c))
            passes.append(AfftPass("i", min(c, lo), lo, hi + 1 - lo, False,
                                   False, twist + tuple(
                                       ("radix", b)
                                       for b in range(hi - 1, lo - 1, -1))))
            if lo == j:
                break
            hi = lo
    ops = []
    for j in range(j0, m):
        ops += [("twist", j)] + [("radix", b)
                                 for b in range(m - 2, j - 1, -1)]
    ops += [("unwind", j) for j in range(m - j0)]
    passes.append(AfftPass("i", min(c, j0), j0, m - j0, False, False,
                           tuple(ops)))
    # the last j0 unwind levels mix output bits m - j0 .. m - 1
    lo = m - j0
    rev = True
    while lo < m:
        if m - lo <= B:
            low, win = min(3, B - (m - lo), lo), m - lo
        else:
            low = min(3, lo, B // 2)
            win = B - low
        passes.append(AfftPass("o", low, lo, win, rev, False, tuple(
            ("unwind", j) for j in range(lo, lo + win))))
        rev = False
        lo += win
    out = tuple(passes)
    for p in out:
        if p.bits > B or len(p.ops) > MAX_OPS or p.lo < p.low:
            raise AssertionError(f"additive_fft_plan: bad pass {p}")
    return out


def inverse_plan(plan) -> Tuple[AfftPass, ...]:
    """The IFFT's passes: the forward passes backwards, each step list
    reversed (the kernel inverts each step), load and store exchanged."""
    return tuple(p._replace(load_rev=p.store_rev, store_rev=p.load_rev,
                            ops=p.ops[::-1]) for p in reversed(plan))


@functools.lru_cache(maxsize=None)
def _encoded(m: int, W: int, inverse: bool):
    """The plan as the launcher reads it: (int32 array, its length, whether
    a scratch buffer is needed).  Per pass: space (1 = o), low, lo, win,
    load_rev, store_rev, number of steps, then kind << 8 | arg a step."""
    plan = additive_fft_plan(m, W)
    if inverse:
        plan = inverse_plan(plan)
    words = []
    for p in plan:
        words += [int(p.space == "o"), p.low, p.lo, p.win, int(p.load_rev),
                  int(p.store_rev), len(p.ops)]
        words += [(_KIND[k] << 8) | a for k, a in p.ops]
    rev_at = [k for k, p in enumerate(plan) if p.load_rev != p.store_rev]
    arr = (ctypes.c_int * len(words))(*words)
    return arr, len(plan), rev_at[0] > 0


def twist_level(tw: torch.Tensor, n: int, j: int) -> torch.Tensor:
    off = 2 * n - 2 * (n >> j)
    return tw[:, off:off + (n >> j)]


def sums_level(sums: torch.Tensor, j: int) -> torch.Tensor:
    return sums[:, (1 << j) - 1:(1 << (j + 1)) - 1]


def _bitrev(x: torch.Tensor, m: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for b in range(m):
        out |= ((x >> b) & 1) << (m - 1 - b)
    return out


def _insert_zero(u: torch.Tensor, pos: int) -> torch.Tensor:
    return (u & ((1 << pos) - 1)) | ((u >> pos) << (pos + 1))


def _pass_index(p: AfftPass, m: int) -> torch.Tensor:
    """(groups, 2^bits) int64: index p of each local element of each block,
    as the kernel forms it from blockIdx.x and the local index."""
    G = 1 << (m - p.bits)
    g = torch.arange(G, dtype=torch.int64)[:, None]
    l = torch.arange(1 << p.bits, dtype=torch.int64)[None, :]
    gap = p.lo - p.low
    base = ((g & ((1 << gap) - 1)) << p.low) | ((g >> gap) << (p.lo + p.win))
    return base | (l & ((1 << p.low) - 1)) | ((l >> p.low) << p.lo)


def additive_fft_passes_model(F, S: torch.Tensor, tw: torch.Tensor,
                              sums: torch.Tensor, inverse: bool,
                              plan=None) -> torch.Tensor:
    """The kernel's passes in PyTorch: each pass gathers its blocks (a row
    of (W, R, groups, 2^bits) each), runs its steps on local positions as
    the kernel does in shared memory, and scatters them back.  ``plan`` is
    a forward plan (default additive_fft_plan(m, W))."""
    shape = S.shape
    W, n = shape[0], shape[-1]
    X = S.reshape(W, -1, n)
    R = X.shape[1]
    m = n.bit_length() - 1
    if plan is None:
        plan = additive_fft_plan(m, W)
    if inverse:
        plan = inverse_plan(plan)
    for p in plan:
        idx = _pass_index(p, m)
        pos_in = _bitrev(idx, m) if p.load_rev else idx
        blk = X[:, :, pos_in.reshape(-1)].reshape(W, R, *idx.shape).clone()
        half = torch.arange(1 << max(p.bits - 1, 0), dtype=torch.int64)
        quarter = torch.arange(1 << max(p.bits - 2, 0), dtype=torch.int64)
        for kind, a in p.ops:
            if kind == "twist":
                off = 2 * n - 2 * (n >> a)
                y = tw[:, off + (idx >> a)]
                blk = gf2k_mul_plain(F, blk, y[:, None])
            elif kind == "radix":
                s1, s2 = p.local_bit(a), p.local_bit(a + 1)
                l0 = _insert_zero(_insert_zero(quarter, s1), s2)
                x1, x2, x3 = l0 | (1 << s1), l0 | (1 << s2), \
                    l0 | (1 << s1) | (1 << s2)
                if inverse:
                    blk[..., x1] ^= blk[..., x2]
                    blk[..., x2] ^= blk[..., x3]
                else:
                    blk[..., x2] ^= blk[..., x3]
                    blk[..., x1] ^= blk[..., x2]
            else:
                bit = a if p.space == "o" else m - 1 - a
                s = p.local_bit(bit)
                l0 = _insert_zero(half, s)
                l1 = l0 | (1 << s)
                p0 = idx[:, l0]
                o0 = p0 if p.space == "o" else _bitrev(p0, m)
                z = sums[:, (1 << a) - 1 + (o0 & ((1 << a) - 1))][:, None]
                x0, y1 = blk[..., l0], blk[..., l1]
                if inverse:
                    y1 = y1 ^ x0
                    x0 = x0 ^ gf2k_mul_plain(F, y1, z)
                else:
                    x0 = x0 ^ gf2k_mul_plain(F, y1, z)
                    y1 = y1 ^ x0
                blk[..., l0], blk[..., l1] = x0, y1
        pos_out = _bitrev(idx, m) if p.store_rev else idx
        Y = torch.empty_like(X)
        Y[:, :, pos_out.reshape(-1)] = blk.reshape(W, R, -1)
        X = Y
    return X.reshape(shape)


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
    domain.  CUDA tensors launch K17, the passes of additive_fft_plan(m, W)
    (whatever R); CPU tensors run the plain twin."""
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
    m = n.bit_length() - 1
    plan, passes, scratch = _encoded(m, binary_words(F), bool(inverse))
    out = torch.empty_like(S)
    tmp = torch.empty_like(S) if scratch else out
    fn = build.launcher("additive_fft", "additive_fft_launch", _ARGTYPES)
    rows = S.shape[1] if S.ndim == 3 else 1
    err = fn(ptr(out), ptr(tmp), ptr(S), ptr(tw), ptr(sums), m, rows,
             int(inverse), binary_words(F), plan, passes, F.kernel_params(),
             stream_ptr(S.device))
    raise_on_error("additive_fft", err)
    LAUNCHES["additive_fft"] += passes
    return out
