"""Linearized (subspace-vanishing) polynomials over GF(2^k).

Port of libiop_tpu/algebra/linearized.py.  For an F2-linear subspace
V = span(b_0..b_{m-1}), Z_V(x) = prod_{v in V} (x - v) has nonzero
coefficients only at degrees 2^i, built by Z_{j+1} = Z_j^2 + Z_j(b_j) Z_j;
for an affine V + s, Z(x) = Z_V(x) + Z_V(s).  F2-linearity makes its
evaluations over a domain a subset-sum table of its values on the domain's
basis and shift (host ints, then an XOR doubling on the device).  Division
by Z runs through kernel K18 (kernels/linearized.py).
"""
from __future__ import annotations

from typing import List

import torch

from ..fields.binary import BinaryField, subset_sums
from ..kernels.linearized import linearized_divide
from .domains import device_table
from .subspace import AffineSubspace


class LinearizedVanishing:
    """Z of an affine subspace: host-int coefficients, device eval tables."""

    def __init__(self, domain: AffineSubspace):
        F = domain.field
        self.F = F
        self.domain = domain
        coeffs = [1]  # Z_0 = x; c[i] multiplies x^(2^i)
        for b in domain.basis:
            z_b = self._eval_linear(coeffs, b)
            sq = [0] + [F.mul_ints(c, c) for c in coeffs]
            scaled = [F.mul_ints(z_b, c) for c in coeffs] + [0]
            coeffs = [a ^ b2 for a, b2 in zip(sq, scaled)]
        self.linear_coeffs = coeffs
        self.constant = self._eval_linear(coeffs, domain.shift)

    def _eval_linear(self, coeffs: List[int], x: int) -> int:
        F = self.F
        acc = 0
        p = x
        for c in coeffs:
            acc ^= F.mul_ints(c, p)
            p = F.mul_ints(p, p)
        return acc

    def eval_at_point_int(self, x: int) -> int:
        return self._eval_linear(self.linear_coeffs, x) ^ self.constant

    @property
    def epsilon(self) -> int:
        """The coefficient of x (the additive sumcheck's eps)."""
        return self.linear_coeffs[0]

    def formal_derivative(self) -> int:
        """Z'(x), the constant eps: in characteristic 2 only the x term of
        a linearized polynomial survives differentiation."""
        return self.linear_coeffs[0]

    def evals_over(self, L: AffineSubspace, device) -> torch.Tensor:
        """(W, |L|) evaluations over L (memoized per device): Z on L's
        basis and shift, then subset sums."""
        F = self.F

        def compute():
            z_basis = [self._eval_linear(self.linear_coeffs, b)
                       for b in L.basis]
            return subset_sums(
                F.from_ints(z_basis, device).reshape(F.W, len(z_basis)),
                F.from_ints([self.eval_at_point_int(L.shift)], device))

        return device_table(("zlin", self.domain._key(), L._key()), device,
                            compute)

    def coeffs_dense_positions(self):
        """[(degree, coeff_int)] of the nonzero terms, constant included."""
        out = [(0, self.constant)] if self.constant else []
        for i, c in enumerate(self.linear_coeffs):
            if c:
                out.append((1 << i, c))
        return out


def divide_by_linearized(F: BinaryField, coeffs: torch.Tensor,
                         Z: LinearizedVanishing):
    """(quotient, remainder) of (W, d) coefficients by Z (degree h): widths
    d - h and h, or 0 and h (zero-padded) when d <= h (kernel K18 on the
    card: the reference's fold of chunks of h/2)."""
    h = Z.domain.order
    d = coeffs.shape[-1]
    if d <= h:
        return (F.zeros((0,), coeffs.device),
                torch.cat([coeffs, F.zeros((h - d,), coeffs.device)], dim=1))
    sparse = [(deg, c) for deg, c in Z.coeffs_dense_positions() if deg < h]
    return linearized_divide(F, coeffs.contiguous(), sparse, h)
