"""The port's succinct matrices against the reference, on the cases of
tests/test_succinct_matrices.py: the identity and the shifted identity over
a successor-ordered domain (a random z of degree < |S| by interpolation,
every systematic value checked, both packages' extensions compared at
points on and off S), and the semi-succinct wrapper.  Host ints, compared
live; the interpolation is the port's on the CPU."""
import numpy as np
import pytest

from libiop_tpu.algebra import trace_embedding as ref_te
from libiop_tpu.algebra.generic import make_domain as ref_make_domain
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu.relations import succinct as ref_succinct
from libiop_tpu_torch.algebra.generic import ifft_any, make_domain
from libiop_tpu_torch.algebra.trace_embedding import SuccessorOrdering
from libiop_tpu_torch.fields.binary import gf64
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.relations.sparse import SparseMatrix
from libiop_tpu_torch.relations.succinct import (HostPolynomial,
                                                 IdentityMatrix,
                                                 ShiftedIdentityMatrix,
                                                 StandardSemisuccinctMatrix)

FIELDS = {"edwards_Fr": (edwards_fr, ref_prime.edwards_fr),
          "gf64": (gf64, ref_binary.gf64)}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_succinct_matrices_match_reference(name):
    F, RF = FIELDS[name][0](), FIELDS[name][1]()
    rng = np.random.default_rng(1)
    coeffs = F.random_ints(9, rng)
    z, rz = HostPolynomial(F, coeffs), ref_succinct.HostPolynomial(RF, coeffs)
    ident = IdentityMatrix(16)
    mz = ident.extend_Mz(z)
    assert (ident.num_rows(), ident.num_columns()) == (16, 16)
    assert mz.degree() == rz.degree() == ident.Mz_degree(z.degree())
    for x in F.random_ints(5, rng):
        assert mz.evaluation_at_point_int(x) == \
            ref_succinct.IdentityMatrix(16).extend_Mz(
                rz).evaluation_at_point_int(x)

    S, RS = make_domain(F, 4), ref_make_domain(RF, 4)
    vals = F.random_ints(S.order, np.random.default_rng(2))
    zc = [int(v) for v in F.to_ints(ifft_any(F.from_ints(vals, "cpu"), S))]
    z, rz = HostPolynomial(F, zc), ref_succinct.HostPolynomial(RF, zc)
    ordering = SuccessorOrdering(S)
    shifted = ShiftedIdentityMatrix(S, ordering)
    mz = shifted.extend_Mz(z)
    rmz = ref_succinct.ShiftedIdentityMatrix(
        RS, ref_te.SuccessorOrdering(RS)).extend_Mz(rz)
    assert mz.degree() == rmz.degree() == shifted.Mz_degree(z.degree())
    first = ordering.first_elem()
    assert mz.evaluation_at_point_int(first) == 0
    cur = ordering.next_elem(first)
    for _ in range(S.order - 1):
        nxt = ordering.next_elem(cur)
        assert mz.evaluation_at_point_int(cur) == \
            z.evaluation_at_point_int(nxt) == rmz.evaluation_at_point_int(cur)
        cur = nxt
    for x in F.random_ints(3, np.random.default_rng(3)):
        assert mz.evaluation_at_point_int(x) == rmz.evaluation_at_point_int(x)


def test_semisuccinct_wrapper():
    F = edwards_fr()
    A = IdentityMatrix(4)
    B = SparseMatrix.from_entries(F, 2, 2, [(0, 0, 1), (1, 1, 5)])
    M = StandardSemisuccinctMatrix(A, B)
    assert M.get_succinct_matrix() is A
    assert M.get_unstructured_matrix() is B
