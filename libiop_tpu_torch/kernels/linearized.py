"""K18: division by and multiplication by a linearized vanishing polynomial
(csrc/linearized.cu), and their plain twins.

Z is given by its sparse terms [(degree, coefficient int)]; the division
takes the terms below x^h (Z is monic of degree h), the product every term.
A division by a Z of degree h <= SCAN_MAX_H runs as a blocked scan over
segments of ``scan_segment(d, h)`` quotient positions
(``linearized_divide_scan_model`` is the same algorithm in PyTorch); a
larger Z takes one launch a chunk of h/2.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, ptr,
               raise_on_error, stream_ptr)
from .gf2k_mul import gf2k_mul_plain

MAX_TERMS = 34
#: coefficient stride in the launch parameters (gf::kMaxWords)
MAX_WORDS = 8
#: the largest Z the blocked scan takes (csrc/linearized.cu kScanMaxH)
SCAN_MAX_H = 128
#: the longest segment the scan plans (its shared memory at 8 words)
SCAN_MAX_SEGMENT = 2048
#: a carry step's latency in chunk steps (h^2 Horner products against a
#: chunk's table lookups), the weight of the segment count in the plan
CARRY_STEP = 8


class _Terms(ctypes.Structure):
    _fields_ = [("deg", ctypes.c_longlong * MAX_TERMS),
                ("c", ctypes.c_uint32 * (MAX_TERMS * MAX_WORDS)),
                ("n_terms", ctypes.c_int)]


_DIV_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p]
_MUL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _coeff(F, c: int, device) -> torch.Tensor:
    return F.from_ints([c], device).reshape(F.W, 1)


def linearized_divide_plain(F, coeffs: torch.Tensor, terms, h: int):
    """The reference's chunked fold (linearized.py:105-125), the products of
    a chunk by every term in one call."""
    d = coeffs.shape[1]
    work = coeffs.clone()
    cs = F.from_ints([c for _, c in terms], coeffs.device).reshape(
        F.W, len(terms), 1)
    chunk = max(1, h // 2)
    top = d
    while top > h and terms:
        size = min(chunk, top - h)
        prods = gf2k_mul_plain(F, work[:, None, top - size:top], cs)
        for q, (deg, _) in enumerate(terms):
            lo = top - size - h + deg
            work[:, lo:lo + size] ^= prods[:, q]
        top -= size
    return work[:, h:].contiguous(), work[:, :h].contiguous()


def scan_segment(d: int, h: int) -> int:
    """Segment length B of the blocked scan dividing d coefficients by a Z
    of degree h, or 0 when the division takes one launch a chunk (h above
    SCAN_MAX_H).  B is a multiple of the chunk h/2 and at least h; it
    minimizes the dependent steps, 2 B/(h/2) chunk steps of the two segment
    passes plus CARRY_STEP for each of the S - 1 carry steps."""
    if h > SCAN_MAX_H or d <= h:
        return 0
    chunk = max(1, h // 2)
    B = max(chunk, h)
    best = None
    while True:
        S = -(-(d - h) // B)
        cost = 2 * (B // chunk) + CARRY_STEP * (S - 1)
        if best is None or cost < best[0]:
            best = (cost, B)
        if S == 1 or 2 * B > SCAN_MAX_SEGMENT:
            return best[1]
        B *= 2


def scan_scratch_words(W: int, n_terms: int, h: int, d: int, B: int) -> int:
    """32-bit words of the scan's scratch: the nibble tables, the transition
    T (h x h), the segments' lowest h values and their incoming states."""
    S = -(-(d - h) // B)
    return (n_terms * 8 * W * 16 * W + h * h * W + (S - 1) * h * W
            + S * h * W)


def _solve_segments(F, f, state, cs, offs, chunk, floor=None):
    """The recurrence over G segments at once, as one block a segment runs
    it: f (W, G, n) the segments' coefficients bottom up, state (W, G, h)
    the values above them; chunks of ``chunk`` from the top.  ``floor``
    (bottom segment only): positions below it take no sources below h, the
    index of h in the segment."""
    n, h = f.shape[2], state.shape[2]
    buf = torch.cat([f, state], dim=2)
    top = n
    while top > 0:
        size = min(chunk, top)
        p0 = top - size
        acc = buf[:, :, p0:top].clone()
        for q, off in enumerate(offs):
            src = buf[:, :, p0 + off:top + off]
            if floor is not None:
                keep = torch.arange(p0 + off, top + off) >= floor
                src = src * keep.to(src.dtype)
            acc ^= gf2k_mul_plain(F, src, cs[:, q:q + 1, None])
        buf[:, :, p0:top] = acc
        top = p0
    return buf[:, :, :n]


def linearized_divide_scan_model(F, coeffs: torch.Tensor, terms, h: int,
                                 B: int):
    """K18's blocked scan in PyTorch, segment by segment as the kernel runs
    it (csrc/linearized.cu): the local solves of the S - 1 upper segments
    from zero states and the transition T from the unit states (pass 1),
    the carries down the segments (pass 2), the solves from the true states
    with the bottom segment running on over the remainder (pass 3).  Any
    B >= h that the chunk h/2 divides; equals linearized_divide_plain."""
    W, d = F.W, coeffs.shape[1]
    chunk = max(1, h // 2)
    if d <= h or not terms:
        return coeffs[:, h:].clone(), coeffs[:, :h].clone()
    if B < h or B % chunk:
        raise ValueError(f"scan model: segment {B} for h = {h}")
    dev = coeffs.device
    cs = F.from_ints([c for _, c in terms], dev).reshape(W, len(terms))
    offs = [h - deg for deg, _ in terms]
    S = -(-(d - h) // B)
    # segment s holds [d - (s+1) B, d - s B), s < S - 1
    states = [coeffs.new_zeros((W, h))]
    work = coeffs.clone()
    if S > 1:
        upper = torch.stack([coeffs[:, d - (s + 1) * B:d - s * B]
                             for s in range(S - 1)], dim=1)
        units = coeffs.new_zeros((W, h, h))
        units[0] = torch.eye(h, dtype=coeffs.dtype)
        local = _solve_segments(
            F, torch.cat([upper, coeffs.new_zeros((W, h, B))], dim=1),
            torch.cat([coeffs.new_zeros((W, S - 1, h)), units], dim=1),
            cs, offs, chunk)
        lowest, T = local[:, :S - 1, :h], local[:, S - 1:, :h]  # T[:, j, i]
        for s in range(S - 1):
            prods = gf2k_mul_plain(F, T, states[-1][:, :, None])
            y = lowest[:, s].clone()
            for j in range(h):
                y ^= prods[:, j]
            states.append(y)
        work[:, d - (S - 1) * B:] = _solve_segments(
            F, upper, torch.stack(states[:S - 1], dim=1), cs, offs,
            chunk).flip(1).reshape(W, -1)
    bottom = d - (S - 1) * B
    work[:, :bottom] = _solve_segments(
        F, coeffs[:, None, :bottom], states[S - 1][:, None], cs, offs,
        chunk, floor=h)[:, 0]
    return work[:, h:].contiguous(), work[:, :h].contiguous()


def linearized_multiply_plain(F, coeffs: torch.Tensor, terms, h: int):
    """Z * f term by term (generic.py:207-219)."""
    d = coeffs.shape[1]
    out = coeffs.new_zeros((F.W, d + h))
    for deg, c in terms:
        out[:, deg:deg + d] ^= gf2k_mul_plain(F, coeffs,
                                              _coeff(F, c, coeffs.device))
    return out


def _pack_terms(F, terms) -> _Terms:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"linearized: {len(terms)} terms, the kernel takes "
                         f"at most {MAX_TERMS}")
    prm = _Terms()
    for q, (deg, c) in enumerate(terms):
        prm.deg[q] = deg
        for w in range(F.W):
            prm.c[q * MAX_WORDS + w] = (c >> (32 * w)) & 0xFFFFFFFF
    prm.n_terms = len(terms)
    return prm


def _check(F, name, coeffs, terms, h):
    check_limbs(name, coeffs)
    if coeffs.ndim != 2 or coeffs.shape[0] != F.W or h < 1 \
            or any(not 0 <= deg <= h for deg, _ in terms):
        raise ValueError(f"{name}: bad coefficients {tuple(coeffs.shape)} or "
                         f"terms for h = {h}")


def linearized_divide(F, coeffs: torch.Tensor, terms: List[Tuple[int, int]],
                      h: int):
    """(quotient (W, d - h), remainder (W, h)) of (W, d) coefficients,
    d > h, by the monic Z of degree h whose terms below x^h are ``terms``.
    CUDA tensors launch K18: for h <= SCAN_MAX_H the blocked scan over
    segments of scan_segment(d, h) positions, four launches (two when one
    segment holds the quotient); for a larger Z one launch a chunk of h/2.
    CPU tensors run the plain twin."""
    _check(F, "linearized_divide", coeffs, terms, h)
    d = coeffs.shape[1]
    if any(deg >= h for deg, _ in terms) or d <= h:
        raise ValueError("linearized_divide: terms must lie below x^h and "
                         "the dividend above it")
    if coeffs.device.type == "cpu":
        return linearized_divide_plain(F, coeffs, terms, h)
    B = scan_segment(d, h)
    work = coeffs.clone()
    scratch = torch.empty(
        scan_scratch_words(F.W, len(terms), h, d, B) if B else 0,
        dtype=torch.int32, device=coeffs.device)
    prm = _pack_terms(F, terms)
    count = ctypes.c_int(0)
    fn = build.launcher("linearized", "linearized_divide_launch",
                        _DIV_ARGTYPES)
    err = fn(ptr(work), d, h, ctypes.byref(prm), B, ptr(scratch),
             binary_words(F), F.kernel_params(), stream_ptr(coeffs.device),
             ctypes.byref(count))
    raise_on_error("linearized", err)
    LAUNCHES["linearized"] += count.value
    return work[:, h:].contiguous(), work[:, :h].contiguous()


def linearized_multiply(F, coeffs: torch.Tensor, terms: List[Tuple[int, int]],
                        h: int) -> torch.Tensor:
    """(W, d + h) coefficients of Z * f for f (W, d), Z of degree h given by
    all its terms.  CUDA tensors launch K18 once; CPU tensors run the plain
    twin."""
    _check(F, "linearized_multiply", coeffs, terms, h)
    if coeffs.device.type == "cpu":
        return linearized_multiply_plain(F, coeffs, terms, h)
    d = coeffs.shape[1]
    out = torch.empty((F.W, d + h), dtype=torch.int32, device=coeffs.device)
    prm = _pack_terms(F, terms)
    count = ctypes.c_int(0)
    fn = build.launcher("linearized", "linearized_multiply_launch",
                        _MUL_ARGTYPES)
    err = fn(ptr(out), ptr(coeffs), d, h, ctypes.byref(prm), binary_words(F),
             F.kernel_params(), stream_ptr(coeffs.device), ctypes.byref(count))
    raise_on_error("linearized", err)
    LAUNCHES["linearized"] += count.value
    return out
