"""Succinct and semi-succinct matrices (port of
libiop_tpu/relations/succinct.py; host-int math only).

Counterpart of libiop/relations/succinct_matrix.hpp:21-48 and
succinct_matrices/identity.{hpp,tcc}: matrices whose Mz polynomial extension
is computable in O(log) from z's extension — the structured half of
succinct-Aurora's semi-succinct matrices (A (x) B with A succinct, B small
and unstructured).

Host-int polynomial semantics: ``extend_Mz`` consumes/produces objects with
``evaluation_at_point_int(x)`` / ``degree()`` (duck-typed peers of the
reference's polynomial_base).
"""
from __future__ import annotations

from typing import List

from ..algebra.generic import (lagrange_poly_eval_at_point_int_any,
                               linearized_vanishing, is_additive)
from ..algebra.trace_embedding import SuccessorOrdering
from .sparse import SparseMatrix


class SuccinctMatrix:
    """Interface (succinct_matrix.hpp:21-34)."""

    def num_rows(self) -> int:
        raise NotImplementedError

    def num_columns(self) -> int:
        raise NotImplementedError

    def extend_Mz(self, z):
        raise NotImplementedError

    def Mz_degree(self, z_degree: int) -> int:
        raise NotImplementedError


class IdentityMatrix(SuccinctMatrix):
    """Mz = z (identity.tcc:6-33)."""

    def __init__(self, num_rows: int):
        self._n = num_rows

    def num_rows(self) -> int:
        return self._n

    def num_columns(self) -> int:
        return self._n

    def extend_Mz(self, z):
        return z

    def Mz_degree(self, z_degree: int) -> int:
        return z_degree


class _ShiftedIdentityExtendedPolynomial:
    """z(succ(x)) - z(succ(first)) * L_first(x), L_first the NORMALIZED
    Lagrange indicator of the ordering's first element
    (identity.tcc:35-85 shifted_identity_extended_polynomial)."""

    def __init__(self, S, ordering: SuccessorOrdering, z):
        self.F = S.field
        self.S = S
        self.ordering = ordering
        self.z = z
        second = ordering.next_elem(ordering.first_elem())
        self.z_at_second = z.evaluation_at_point_int(second)
        self.first = ordering.first_elem()
        # normalization constant: L(first, first) = Z'(first)
        F = self.F
        if is_additive(S):
            norm = linearized_vanishing(S).epsilon
        else:
            norm = F.mul_ints(S.order % F.field_size,
                              F.pow_int(S.shift, S.order - 1))
        self._norm_inv = F.inv_int(norm)

    def evaluation_at_point_int(self, x: int) -> int:
        """On S this equals the canonical Mz extension; off S the additive
        piecewise composition exceeds the canonical degree (the reference's
        additive compose is unimplemented entirely, identity.tcc TODO —
        protocols only consume systematic values)."""
        F = self.F
        succ_val = self.z.evaluation_at_point_int(
            self.ordering.polynomial.evaluation_at_point_int(x))
        indicator = F.mul_ints(
            lagrange_poly_eval_at_point_int_any(self.S, self.first, x),
            self._norm_inv)
        return F.sub_ints(succ_val, F.mul_ints(self.z_at_second, indicator))

    def degree(self) -> int:
        """Degree of the canonical (efficient) Mz extension
        (identity.tcc Mz_degree)."""
        return max(self.S.order - 1, self.z.degree())


class ShiftedIdentityMatrix(SuccinctMatrix):
    """The shifted identity over a successor-ordered domain S: in ordering
    coordinates, row e_i selects z(e_{i+1}), with the first row zeroed
    (identity.tcc:86-118)."""

    def __init__(self, S, ordering: SuccessorOrdering):
        self.S = S
        self.ordering = ordering

    def num_rows(self) -> int:
        return self.S.order

    def num_columns(self) -> int:
        return self.S.order

    def extend_Mz(self, z):
        return _ShiftedIdentityExtendedPolynomial(self.S, self.ordering, z)

    def Mz_degree(self, z_degree: int) -> int:
        return max(self.S.order - 1, z_degree)


class StandardSemisuccinctMatrix:
    """A (x) B with A succinct and B small/unstructured
    (succinct_matrix.hpp:36-62)."""

    def __init__(self, succinct: SuccinctMatrix, sparse: SparseMatrix):
        self._succinct = succinct
        self._sparse = sparse

    def get_succinct_matrix(self) -> SuccinctMatrix:
        return self._succinct

    def get_unstructured_matrix(self) -> SparseMatrix:
        return self._sparse


class HostPolynomial:
    """Minimal host-int dense polynomial (coefficient list) implementing the
    duck-typed interface the succinct matrices consume."""

    def __init__(self, F, coeffs: List[int]):
        self.F = F
        self.coeffs = list(coeffs)

    def evaluation_at_point_int(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = self.F.add_ints(self.F.mul_ints(acc, x), c)
        return acc

    def degree(self) -> int:
        d = len(self.coeffs) - 1
        while d > 0 and self.coeffs[d] == 0:
            d -= 1
        return d
