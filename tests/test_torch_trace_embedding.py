"""The port's trace embeddings against the reference, on the cases of
tests/test_trace_embedding.py: primitive polynomials over GF(2), successor
orderings (first element, successor walk and piecewise polynomial) over
cosets and subspaces, and the bivariate embeddings' row and column maps.
Host ints on both sides, compared live."""
import pytest

from libiop_tpu.algebra import trace_embedding as ref_te
from libiop_tpu.algebra.generic import make_domain as ref_make_domain
from libiop_tpu.algebra.subspace import AffineSubspace as RefSubspace
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu_torch.algebra import trace_embedding as te
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.interop import domain_from_reference

#: tests/test_trace_embedding.py's domains: (port field, JAX field, dim,
#: shift or None for the canonical domain, "coset" | "subspace")
DOMAINS = [
    (edwards_fr, ref_prime.edwards_fr, 5, None),
    (edwards_fr, ref_prime.edwards_fr, 5, "generator"),
    (binary.gf64, ref_binary.gf64, 5, None),
    (binary.gf192, ref_binary.gf192, 6, None),
    (binary.gf64, ref_binary.gf64, 5, 37),
    (edwards_fr, ref_prime.edwards_fr, 4, None),
    (binary.gf64, ref_binary.gf64, 4, None),
    (binary.gf64, ref_binary.gf64, 4, 21),
]


def _domains(make, make_ref, dim, shift):
    RF = make_ref()
    if shift == "generator":
        RD = ref_make_domain(RF, dim, shift=RF.multiplicative_generator)
    elif shift is None:
        RD = ref_make_domain(RF, dim)
    else:
        RD = RefSubspace(RF, dim, shift=shift)
    return domain_from_reference(make(), RD), RD


def test_primitive_polynomials_match_reference():
    for d in (2, 3, 4, 6, 8, 10, 13, 20):
        assert te.primitive_polynomial_int(d) == \
            ref_te.primitive_polynomial_int(d)
        f = te.primitive_polynomial_int(d)
        assert te._gf2_polypowmod(2, (1 << d) - 1, f, d) == 1


def test_successor_orderings_match_reference():
    """first_elem and the whole next_elem walk equal the JAX package's; the
    port's piecewise polynomial equals next_elem at every element, and the
    JAX package's polynomial at the walk's first 16 (its host GF(2^k)
    inverse is bit-serial)."""
    for make, make_ref, dim, shift in DOMAINS:
        D, RD = _domains(make, make_ref, dim, shift)
        o, ro = te.SuccessorOrdering(D), ref_te.SuccessorOrdering(RD)
        assert o.first_elem() == ro.first_elem()
        poly, rpoly = o.piecewise_polynomial(), ro.piecewise_polynomial()
        assert (poly.degree(), poly.piecewise_degree()) == \
            (rpoly.degree(), rpoly.piecewise_degree())
        cur, walk = o.first_elem(), {}
        for step in range(D.order):
            walk[cur] = o.next_elem(cur)
            assert walk[cur] == ro.next_elem(cur)
            if step < 16:
                assert rpoly.evaluation_at_point_int(cur) == walk[cur]
            cur = walk[cur]
        assert len(walk) == D.order
        assert poly.evaluations_over(D) == [
            walk[D.element_by_index_int(i)] for i in range(D.order)]


def test_bivariate_embeddings_match_reference():
    """The additive (gf64, dim 6 split at 2) and multiplicative (edwards_Fr,
    8 x 5) embeddings: the component domains and both projections of every
    element of H equal the JAX package's."""
    emb, H1, H2 = te.BivariateEmbedding.build_additive(binary.gf64(), 6, 2)
    remb, RH1, RH2 = ref_te.BivariateEmbedding.build_additive(
        ref_binary.gf64(), 6, 2)
    assert (H1.shift, H1.basis, H2.shift, H2.basis) == \
        (RH1.shift, RH1.basis, RH2.shift, RH2.basis)
    memb, M1, M2 = te.BivariateEmbedding.build_multiplicative(edwards_fr(),
                                                              8, 5)
    rmemb, RM1, RM2 = ref_te.BivariateEmbedding.build_multiplicative(
        ref_prime.edwards_fr(), 8, 5)
    assert (M1.g, M2.g, memb.H.g) == (RM1.g, RM2.g, rmemb.H.g)
    for e, re_ in ((emb, remb), (memb, rmemb)):
        pairs = set()
        for i in range(e.H.order):
            x = e.H.element_by_index_int(i)
            assert x == re_.H.element_by_index_int(i)
            pair = (e.project_to_row(x), e.project_to_col(x))
            assert pair == (re_.project_to_row(x), re_.project_to_col(x))
            pairs.add(pair)
        assert len(pairs) == e.H.order
    for i in range(M1.order):
        assert M1.contains(M1.element_by_index_int(i))
    with pytest.raises(AssertionError):
        te.BivariateEmbedding.build_multiplicative(edwards_fr(), 8, 4)
