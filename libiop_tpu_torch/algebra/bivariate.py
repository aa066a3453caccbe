"""Standalone bivariate Lagrange polynomial and subspace basis utilities
(port of libiop_tpu/algebra/bivariate.py).

Role parity with the reference:

* ``BivariateLagrange`` —
  libiop/algebra/polynomials/bivariate_lagrange_polynomial.hpp:22-45:
  the succinct low-degree extension of the unnormalized Lagrange basis of a
  domain S,  f(X, Y) = (Z_S(X) - Z_S(Y)) / (X - Y),  with f(x, x) = Z_S'(x),
  with the reference's three entry points (``evaluation_at_point``,
  ``fix_x``, ``evaluations_over_field_subset``);
* ``monomial_basis`` / ``transform_basis_by_polynomial`` —
  libiop/algebra/field_subset/basis_utils.hpp:19-29.

``evaluations_over`` is one launch of kernel K22 (kernels/bivariate.py) over
the memoized device tables of L's elements and of Z_S over L, with the
y = x diagonal patched in the same launch.  Both domain families
(multiplicative cosets and affine subspaces) go through the field-generic
host-int layer (algebra/generic.py).
"""
from __future__ import annotations

from typing import List

import torch

from ..device import resolve_device
from ..kernels.bivariate import bivariate_evals
from .generic import (
    is_additive,
    lagrange_coeffs_ints_any,
    vanishing_derivative_int,
    vanishing_eval_int,
    vanishing_evals_over_any,
)


def index_of_element(L, x: int) -> int:
    """The index i with L.element_by_index_int(i) == x, or -1 when x is not
    in L, in O(dim^2) host operations: over a coset the discrete log of
    x / shift to the base g, bit by bit (g has order 2^dim); over a subspace
    the coordinates of x - shift in L's basis, by elimination over GF(2)."""
    F = L.field
    if is_additive(L):
        pivots = []  # (vector, index bits), reduced on their top bits
        for j, b in enumerate(L.basis):
            v, m = b, 1 << j
            for pv, pm in pivots:
                if v ^ pv < v:
                    v, m = v ^ pv, m ^ pm
            if v:
                pivots.append((v, m))
                pivots.sort(reverse=True)
        v, i = x ^ L.shift, 0
        for pv, pm in pivots:
            if v ^ pv < v:
                v, i = v ^ pv, i ^ pm
    else:
        p = F.p
        h = x * pow(L.shift, p - 2, p) % p
        if pow(h, L.order, p) != 1:
            return -1
        g_inv = pow(L.g, p - 2, p)
        i = 0
        for j in range(L.dim):
            t = h * pow(g_inv, i, p) % p
            if pow(t, 1 << (L.dim - 1 - j), p) != 1:
                i |= 1 << j
    return i if L.element_by_index_int(i) == x else -1


class BivariateLagrange:
    """f(X, Y) = (Z_S(X) - Z_S(Y)) / (X - Y) for a domain S.

    Degree |S| - 1 in Y; identifies elements of S with Y
    (bivariate_lagrange_polynomial.hpp:22-31).
    """

    def __init__(self, S):
        self.S = S
        self.F = S.field

    def evaluation_at_point_int(self, x: int, y: int) -> int:
        """f(x, y) as host ints (bivariate_lagrange_polynomial.tcc
        evaluation_at_point semantics, with the x == y diagonal)."""
        F = self.F
        if x == y:
            return vanishing_derivative_int(self.S, x)
        num = F.sub_ints(vanishing_eval_int(self.S, x),
                         vanishing_eval_int(self.S, y))
        return F.mul_ints(num, F.inv_int(F.sub_ints(x, y)))

    def fix_x(self, c: int) -> List[int]:
        """Y -> f(c, Y) as its dense evaluations over S in domain order:
        the Lagrange coefficients of S at c scaled back by Z_S'(s), i.e.
        Z_S(c) / (c - s) (the reference returns a lagrange_polynomial
        object; evaluations_over and evaluation_at_point_int play that
        role here)."""
        F = self.F
        coeffs = lagrange_coeffs_ints_any(self.S, c)
        return [F.mul_ints(coeffs[i],
                           vanishing_derivative_int(
                               self.S, self.S.element_by_index_int(i)))
                for i in range(self.S.order)]

    def evaluations_over(self, x: int, L, device="cuda") -> torch.Tensor:
        """f(x, y) for every y of the domain L as the field's (L, |L|) limbs
        or words (bivariate_lagrange_polynomial.tcc
        evaluations_over_field_subset): one K22 launch on the card."""
        dev = resolve_device(device)
        S = self.S
        return bivariate_evals(
            self.F, L.elements(dev), vanishing_evals_over_any(S, L, dev), x,
            vanishing_eval_int(S, x), vanishing_derivative_int(S, x),
            index_of_element(L, x))


def monomial_basis(F, dimension: int, smallest_exponent: int) -> List[int]:
    """Basis x^i, ..., x^{i+d-1} of the rational function field: the
    F2-linear basis elements 2^i as field ints for binary fields, or
    generator powers for prime fields (basis_utils.tcc monomial_basis)."""
    if F.kind == "additive":
        # binary field: the monomial x^k of the polynomial representation
        # is the integer 2^k
        return [1 << (smallest_exponent + k) for k in range(dimension)]
    g = F.multiplicative_generator
    cur = F.pow_int(g, smallest_exponent)
    out = []
    for _ in range(dimension):
        out.append(cur)
        cur = F.mul_ints(cur, g)
    return out


def transform_basis_by_polynomial(evaluate_at_point, basis: List[int]
                                  ) -> List[int]:
    """Map each basis element through a polynomial's point-evaluation
    callable (basis_utils.tcc transform_basis_by_polynomial: pushes a
    subspace basis through a linearized map)."""
    return [evaluate_at_point(b) for b in basis]
