"""Trace embedding: bivariate embeddings H ~= H1 x H2 and successor orderings
(port of libiop_tpu/algebra/trace_embedding.py; host-int math only).

Counterpart of libiop/algebra/trace_embedding/ (bivariate_embedding.hpp:19-55,
successor_ordering.hpp:17-120, multiplicative/additive_successor_ordering.tcc)
and algebra/polynomials/piecewise_polynomial.hpp — the algebraic machinery of
succinct-Aurora-style protocols:

* a bivariate embedding is a bijection f(h) = (f1(h), f2(h)) from H onto
  H1 x H2 where f1, f2 are O(log|H|)-evaluable polynomial maps:
  - additive: H = V (+) W (basis split); f1 = Z_W, f2 = Z_V, and
    H1 = Z_W(V), H2 = Z_V(W) (images under the linearized vanishing maps);
  - multiplicative: |H1| and |H2| coprime (one a power of two), f1 = x^|H2|,
    f2 = x^|H1| (the k-to-1 maps of Z_{H2} / Z_{H1}, subgroups only);
* a successor ordering is a designated first element plus a piecewise-degree-1
  polynomial mapping each element of S to its successor, inducing the
  bijection Z_|S| -> S:
  - multiplicative: first = shift, next(x) = g*x;
  - additive ([BCGGRS19]): S is identified with GF(2^dim)^* extended by 0 —
    partitions {0}, S'\\{0}, S' + g^{dim-1} with successors 1, g*x, and
    g*x + f_prim(g) where f_prim is a primitive polynomial of degree dim
    (computed here from scratch, not tabulated).

Everything here is host-int math (verifier side): these maps are O(log)
scalars inside succinct protocols, not codeword-sized tensor work.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

from ..fields.binary import BinaryField
from .generic import (is_additive, lagrange_poly_eval_at_point_int_any,
                      linearized_vanishing)
from .linearized import LinearizedVanishing
from .subspace import AffineSubspace


# ---------------------------------------------------------------------------
# primitive polynomials over GF(2), computed (not tabulated)
# ---------------------------------------------------------------------------
def _gf2_polymulmod(a: int, b: int, f: int, d: int) -> int:
    """Carry-less a*b mod f, f of degree d (ints as bit-polynomials)."""
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a <<= 1
        if (a >> d) & 1:
            a ^= f
    return res


def _gf2_polypowmod(a: int, e: int, f: int, d: int) -> int:
    res = 1
    while e:
        if e & 1:
            res = _gf2_polymulmod(res, a, f, d)
        a = _gf2_polymulmod(a, a, f, d)
        e >>= 1
    return res


def _prime_factors(n: int) -> List[int]:
    out = []
    x = n
    p = 2
    while p * p <= x:
        if x % p == 0:
            out.append(p)
            while x % p == 0:
                x //= p
        p += 1 if p == 2 else 2
    if x > 1:
        out.append(x)
    return out


@functools.lru_cache(maxsize=None)
def primitive_polynomial_int(d: int) -> int:
    """Bits of a degree-d primitive polynomial over GF(2) (x is a generator
    of GF(2^d)^*).  Role of the reference's Conway-polynomial table
    (additive_successor_ordering.tcc:26-69) — any primitive polynomial works
    there, so we search for the lexicographically-smallest one: f is
    primitive iff x^(2^d-1) = 1 mod f and x^((2^d-1)/q) != 1 for every prime
    q | 2^d - 1 (which also implies irreducibility for d >= 2)."""
    assert 2 <= d <= 64
    m = (1 << d) - 1
    qs = _prime_factors(m)
    for low in range(1, 1 << d, 2):  # constant term must be 1
        f = (1 << d) | low
        if _gf2_polypowmod(2, m, f, d) != 1:
            continue
        if all(_gf2_polypowmod(2, m // q, f, d) != 1 for q in qs):
            return f
    raise RuntimeError(f"no primitive polynomial of degree {d} found")


# ---------------------------------------------------------------------------
# piecewise polynomials (piecewise_polynomial.hpp role)
# ---------------------------------------------------------------------------
class PiecewisePolynomial:
    """A polynomial defined partition-wise; ``piecewise_degree`` is the max
    degree of the per-partition value polynomials (1 for successor maps)."""

    def degree(self) -> int:
        raise NotImplementedError

    def piecewise_degree(self) -> int:
        raise NotImplementedError

    def evaluation_at_point_int(self, x: int) -> int:
        raise NotImplementedError

    def evaluations_over(self, domain) -> List[int]:
        return [self.evaluation_at_point_int(domain.element_by_index_int(i))
                for i in range(domain.order)]


class MultiplicativeSuccessorPolynomial(PiecewisePolynomial):
    """next(x) = g * x (one partition)."""

    def __init__(self, F, generator: int):
        self.F = F
        self.g = generator

    def degree(self) -> int:
        return 1

    def piecewise_degree(self) -> int:
        return 1

    def evaluation_at_point_int(self, x: int) -> int:
        return self.F.mul_ints(self.g, x)


class AdditiveSuccessorPolynomial(PiecewisePolynomial):
    """[BCGGRS19] additive successor polynomial over a standard-basis affine
    subspace S (dim i, shift s), identified with GF(2^i):
        partitions {s}, (S'\\{s}), S' + g^{i-1}  (S' = S minus top basis vec)
        successors  1+s, g*(x-s)+s, g*(x-s)+s+f_prim(g)
    realized as  L_{S,0}(x)*(1+s)
               + (L_0(Z_{S'}(x)) - L_{S,0}(x)) * (g*(x-s)+s)
               + L_1(Z_{S'}(x)) * (g*(x-s)+s+f_prim(g))
    (additive_successor_ordering.tcc:71-215)."""

    def __init__(self, S: AffineSubspace):
        F = S.field
        assert S.basis == [1 << j for j in range(S.dim)], \
            "additive successor ordering needs the standard basis"
        self.F = F
        self.S = S
        self.g = 2
        self.f_prim_at_g = primitive_polynomial_int(S.dim)
        self.S_trunc = AffineSubspace(F, S.dim - 1, shift=S.shift,
                                      basis=S.basis[:-1])
        self.Z_trunc = linearized_vanishing(self.S_trunc)
        g_pow = (1 << (S.dim - 1)) ^ S.shift  # g^{i-1} + shift
        self.Z_trunc_at_gpow = self.Z_trunc.eval_at_point_int(g_pow)
        # L_0(y) = k0*(y - Z_trunc_at_gpow) with L_0(0)=1; L_1(y) = k1*y
        self.L0_coeff = F.inv_int(self.Z_trunc_at_gpow)  # -1 == 1 in char 2
        self.L1_coeff = F.inv_int(self.Z_trunc_at_gpow)

    def degree(self) -> int:
        return self.S.order

    def piecewise_degree(self) -> int:
        return 1

    def evaluation_at_point_int(self, x: int) -> int:
        F = self.F
        s = self.S.shift
        z_t = self.Z_trunc.eval_at_point_int(x)
        # normalized Lagrange indicator of the 0th element of S at x
        part0 = lagrange_poly_eval_at_point_int_any(self.S, s, x)
        eps = linearized_vanishing(self.S).epsilon
        part0 = F.mul_ints(part0, F.inv_int(eps))  # normalize: L(s,s)=1
        result = F.mul_ints(part0, 1 ^ s)
        L0 = F.mul_ints(self.L0_coeff, z_t ^ self.Z_trunc_at_gpow)
        gx = F.mul_ints(self.g, x ^ s) ^ s
        result ^= F.mul_ints(L0 ^ part0, gx)
        L1 = F.mul_ints(self.L1_coeff, z_t)
        result ^= F.mul_ints(L1, gx ^ self.f_prim_at_g)
        return result


class SuccessorOrdering:
    """first element + successor map for either domain family
    (successor_ordering.hpp:17-120 + wrapper)."""

    def __init__(self, domain):
        self.domain = domain
        self.F = domain.field
        if is_additive(domain):
            self.polynomial = AdditiveSuccessorPolynomial(domain)
        else:
            self.polynomial = MultiplicativeSuccessorPolynomial(
                domain.field, domain.g)

    def first_elem(self) -> int:
        # element 0 of either family is its shift
        return self.domain.shift

    def next_elem(self, cur: int) -> int:
        """O(1)-int successor (the piecewise polynomial agrees; tested)."""
        if not is_additive(self.domain):
            return self.F.mul_ints(self.domain.g, cur)
        S = self.domain
        x = cur ^ S.shift  # remove the affine shift
        if x == 0:
            return 1 ^ S.shift
        x <<= 1
        if (x >> S.dim) & 1:
            x ^= primitive_polynomial_int(S.dim)
        return x ^ S.shift

    def piecewise_polynomial(self) -> PiecewisePolynomial:
        return self.polynomial


# ---------------------------------------------------------------------------
# bivariate embedding
# ---------------------------------------------------------------------------
class GeneralMultiplicativeSubgroup:
    """Host-int subgroup of F_p^* of arbitrary order n | p-1 (the bivariate
    embedding needs coprime-order components, so power-of-two-only
    MultiplicativeCoset does not suffice).  Element i = g^i."""

    kind = "general_multiplicative_subgroup"

    def __init__(self, F, order: int, generator: Optional[int] = None):
        assert (F.p - 1) % order == 0, "order must divide p-1"
        self.field = F
        self.order = order
        self.g = generator if generator is not None else \
            F.pow_int(F.multiplicative_generator, (F.p - 1) // order)
        self.shift = 1

    def element_by_index_int(self, index: int) -> int:
        return self.field.pow_int(self.g, index)

    def contains(self, x: int) -> bool:
        return self.field.pow_int(x, self.order) == 1


class BivariateEmbedding:
    """f(h) = (project_to_row(h), project_to_col(h)), a bijection
    H -> H1 x H2 (bivariate_embedding.hpp:19-55)."""

    def __init__(self, H, H1, H2):
        self.H, self.H1, self.H2 = H, H1, H2
        self.F = H.field
        assert H.order == H1.order * H2.order, "|H| != |H1|*|H2|"
        if isinstance(H, AffineSubspace):
            d1 = H1.dim
            V = AffineSubspace(self.F, d1, 0, H.basis[:d1])
            W = AffineSubspace(self.F, H.dim - d1, 0, H.basis[d1:])
            self._row_map = linearized_vanishing(W)   # Z_W : H -> H1
            self._col_map = linearized_vanishing(V)   # Z_V : H -> H2
            # validate H1 = Z_W(V), H2 = Z_V(W) (bivariate_embedding.tcc:60-86)
            assert [self._row_map.eval_at_point_int(b) for b in V.basis] \
                == H1.basis, "H1 is not Z_W(V)"
            assert [self._col_map.eval_at_point_int(b) for b in W.basis] \
                == H2.basis, "H2 is not Z_V(W)"
        else:
            # subgroups only, coprime orders, one a power of two
            assert getattr(H, "shift", 1) == 1, "subgroups only (shift 1)"
            n1, n2 = H1.order, H2.order
            from math import gcd
            assert gcd(n1, n2) == 1, "|H1| and |H2| must be coprime"
            self._row_exp = n2   # x^{|H2|} : H -> H1
            self._col_exp = n1   # x^{|H1|} : H -> H2

    def project_to_row(self, x: int) -> int:
        if isinstance(self.H, AffineSubspace):
            return self._row_map.eval_at_point_int(x)
        return self.F.pow_int(x, self._row_exp)

    def project_to_col(self, x: int) -> int:
        if isinstance(self.H, AffineSubspace):
            return self._col_map.eval_at_point_int(x)
        return self.F.pow_int(x, self._col_exp)

    # -- factories ----------------------------------------------------------
    @staticmethod
    def build_additive(F: BinaryField, dim: int, row_dim: int,
                       shift: int = 0) -> Tuple["BivariateEmbedding",
                                                AffineSubspace,
                                                AffineSubspace]:
        """Construct (embedding, H1, H2) for the standard-basis subspace of
        ``dim`` split at ``row_dim``."""
        H = AffineSubspace(F, dim, shift=shift)
        V = AffineSubspace(F, row_dim, 0, H.basis[:row_dim])
        W = AffineSubspace(F, dim - row_dim, 0, H.basis[row_dim:])
        Zw, Zv = LinearizedVanishing(W), LinearizedVanishing(V)
        H1 = AffineSubspace(F, row_dim, Zw.eval_at_point_int(shift),
                            [Zw.eval_at_point_int(b) for b in V.basis])
        H2 = AffineSubspace(F, dim - row_dim, Zv.eval_at_point_int(shift),
                            [Zv.eval_at_point_int(b) for b in W.basis])
        assert shift == 0, "affine embeddings need matching component shifts"
        return BivariateEmbedding(H, H1, H2), H1, H2

    @staticmethod
    def build_multiplicative(F, pow2_order: int, odd_order: int
                             ) -> Tuple["BivariateEmbedding",
                                        GeneralMultiplicativeSubgroup,
                                        GeneralMultiplicativeSubgroup]:
        """(embedding, H1, H2) with |H1| = pow2_order, |H2| = odd_order."""
        H = GeneralMultiplicativeSubgroup(F, pow2_order * odd_order)
        H1 = GeneralMultiplicativeSubgroup(F, pow2_order)
        H2 = GeneralMultiplicativeSubgroup(F, odd_order)
        return BivariateEmbedding(H, H1, H2), H1, H2
