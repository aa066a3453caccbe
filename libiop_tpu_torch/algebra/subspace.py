"""Affine subspaces of GF(2^k) and the Gao-Mateer additive FFT.

Port of libiop_tpu/algebra/subspace.py.  A domain is basis (b_0..b_{m-1})
+ shift, elements enumerated by subset sums (with the standard basis
b_j = x^j, element(i) = shift XOR i); a size-c sub-coset occupies the
consecutive positions [j*c, (j+1)*c).  The FFT's per-level beta and shift
bookkeeping is host-int work of O(m^2) products; its tables (twist powers
of each level's beta, unwind subset sums) are built on the device (powers
by doubling through K16, subset sums by XOR doubling) and memoized per
domain in ``device_table``.  The levels run through kernel K17
(kernels/additive_fft.py).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..fields.binary import BinaryField, subset_sums
from ..kernels.additive_fft import additive_fft as _k17
from .domains import device_powers, device_table


def subset_sums_ints(F: BinaryField, basis: List[int], shift: int) -> List[int]:
    """All 2^len(basis) subset sums (XOR) of host ints, subset-sum order."""
    out = [shift]
    for b in basis:
        out = out + [v ^ b for v in out]
    return out


class AffineSubspace:
    kind = "affine_subspace"

    def __init__(self, field: BinaryField, dim: int, shift: int = 0,
                 basis: Optional[List[int]] = None):
        assert dim <= field.k
        self.field = field
        self.dim = dim
        self.order = 1 << dim
        self.shift = shift
        self.basis = list(basis) if basis is not None else \
            [1 << j for j in range(dim)]
        assert len(self.basis) == dim

    def _key(self):
        return (self.field.name, self.dim, self.shift, tuple(self.basis))

    def __eq__(self, other):
        return isinstance(other, AffineSubspace) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"AffineSubspace(dim={self.dim}, field={self.field.name})"

    def num_elements(self) -> int:
        return self.order

    def element_by_index_int(self, index: int) -> int:
        v = self.shift
        for j in range(self.dim):
            if (index >> j) & 1:
                v ^= self.basis[j]
        return v

    def elements(self, device) -> torch.Tensor:
        """(W, order) elements in subset-sum order (memoized per device)."""
        F = self.field
        return device_table(
            ("elems", self._key()), device,
            lambda: subset_sums(F.from_ints(self.basis, device).reshape(
                F.W, self.dim), F.from_ints([self.shift], device)))

    # -- index arithmetic (additive convention: cosets are contiguous) ------
    def reindex_by_subgroup(self, subspace_dim: int, index: int) -> int:
        return index

    def coset_index(self, position: int, coset_size: int) -> int:
        return position // coset_size

    def intra_coset_index(self, position: int, coset_size: int) -> int:
        return position % coset_size

    def position_by_coset_indices(self, coset_index: int,
                                  intra_coset_index: int,
                                  coset_size: int) -> int:
        return coset_index * coset_size + intra_coset_index

    def get_subset_of_order(self, order: int) -> "AffineSubspace":
        dim = order.bit_length() - 1
        return AffineSubspace(self.field, dim, self.shift, self.basis[:dim])


_STAGE_PARAMS: dict = {}


def fft_stage_params(domain: AffineSubspace):
    """The host-int bookkeeping of the reference's _fft_stage_tables
    (subspace.py:104-148): per level j the twist base beta_j and its
    inverse, and the unwind subset sums' basis and shift.  Memoized by
    domain value."""
    key = domain._key()
    hit = _STAGE_PARAMS.get(key)
    if hit is not None:
        return hit
    F = domain.field
    m = domain.dim
    betas = list(domain.basis)
    shift = domain.shift
    twist = []
    rec_betas = []
    rec_shifts = [0] * m
    for j in range(m):
        beta = betas[m - 1 - j]
        beta_inv = F.inv_int(beta)
        twist.append((beta, beta_inv))
        level_new = []
        for i in range(m - 1 - j):
            nb = F.mul_ints(betas[i], beta_inv)
            level_new.append(nb)
            betas[i] = F.mul_ints(nb, nb) ^ nb
        rec_betas.append(level_new)
        ns = F.mul_ints(shift, beta_inv)
        rec_shifts[j] = ns
        shift = F.mul_ints(ns, ns) ^ ns
    flat = [b for lvl in rec_betas for b in lvl]
    ptr = len(flat)
    unwind = []
    for j in range(m):
        ptr -= j
        unwind.append((flat[ptr:ptr + j], rec_shifts[m - 1 - j]))
    out = _STAGE_PARAMS[key] = (twist, unwind)
    return out


def fft_tables(domain: AffineSubspace, device, inverse: bool):
    """(twist powers (W, 2n - 2), unwind subset sums (W, n - 1)) of the
    domain's FFT (inverse twist powers for the IFFT), built on the device
    and memoized per domain: level j's powers of beta_j (or beta_j^-1) by
    doubling, its subset sums by XOR doubling.  The values are the
    reference's tables'."""
    F = domain.field
    n = domain.order

    def twists():
        twist, _ = fft_stage_params(domain)
        if not twist:
            return F.zeros((0,), device)
        return torch.cat([device_powers(
            F, F.from_ints([bi if inverse else b], device).reshape(F.W),
            n >> j) for j, (b, bi) in enumerate(twist)], dim=1)

    def sums():
        _, unwind = fft_stage_params(domain)
        if not unwind:
            return F.zeros((0,), device)
        return torch.cat([subset_sums(
            F.from_ints(popped, device).reshape(F.W, len(popped)),
            F.from_ints([s], device)) for popped, s in unwind], dim=1)

    key = domain._key()
    return (device_table(("afft_tw", inverse, key), device, twists),
            device_table(("afft_sums", key), device, sums))


def additive_fft(coeffs: torch.Tensor, domain: AffineSubspace) -> torch.Tensor:
    """Evaluate (W, d <= n) coefficients over the subspace: (W, n) in
    subset-sum order; (W, R, d) evaluates R polynomials, (W, R, n) (kernel
    K17 on the card, one batched transform)."""
    F = domain.field
    n = domain.order
    d = coeffs.shape[-1]
    if d < n:
        coeffs = torch.cat([coeffs, F.zeros(coeffs.shape[1:-1] + (n - d,),
                                             coeffs.device)], dim=-1)
    tw, sums = fft_tables(domain, coeffs.device, inverse=False)
    return _k17(F, coeffs.contiguous(), tw, sums, inverse=False)


def additive_ifft(evals: torch.Tensor, domain: AffineSubspace) -> torch.Tensor:
    """Inverse of additive_fft: (W, n) evaluations -> (W, n) coefficients
    (or (W, R, n) -> (W, R, n))."""
    tw, sums = fft_tables(domain, evals.device, inverse=True)
    return _k17(domain.field, evals.contiguous(), tw, sums, inverse=True)
