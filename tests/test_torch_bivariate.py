"""The port's bivariate Lagrange polynomial against the reference, on the
domains of tests/test_bivariate.py:20-27 (S of order 8 inside a domain L
of order 32 disjoint from it), over edwards_Fr, alt_bn128_Fr, GF(2^64) and
GF(2^192): evaluations_over (kernel K22's plain twin on the CPU) with x
outside and inside L, evaluation_at_point_int and fix_x (host ints,
compared live), and the basis utilities.  PINS are the sha256s of the JAX
package's evaluations_over limbs (or words), which the slow test
recomputes."""
import hashlib

import numpy as np
import pytest

from libiop_tpu.algebra import bivariate as ref_bivariate
from libiop_tpu.algebra.domains import MultiplicativeCoset as RefCoset
from libiop_tpu.algebra.subspace import AffineSubspace as RefSubspace
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu_torch.algebra.bivariate import (BivariateLagrange,
                                                index_of_element,
                                                monomial_basis,
                                                transform_basis_by_polynomial)
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import domain_from_reference, limbs_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (edwards_fr, ref_prime.edwards_fr),
          "alt_bn128_Fr": (alt_bn128_fr, ref_prime.alt_bn128_fr),
          "gf64": (binary.gf64, ref_binary.gf64),
          "gf192": (binary.gf192, ref_binary.gf192)}

#: (field, "outside" | "inside") -> sha256 of the JAX package's
#: evaluations_over(x, L) as little-endian uint32 (L, 32) limbs or words
PINS = {
    ("edwards_Fr", "outside"):
        "e1b644b1623c78a370ac9e18015bcf143345bc737ed348ebd9737d27b9b263ce",
    ("edwards_Fr", "inside"):
        "328e830d10cc52d4695887fcf7677de1dd51b166b04e0676f5a1f66be0127bd7",
    ("alt_bn128_Fr", "outside"):
        "47793c34d0c89a3c387aa67484e2ffa9948c55ce4d54084bb2728a90a72ec9ac",
    ("alt_bn128_Fr", "inside"):
        "242418f758c010290eab93922975778ab019c28e35d1f0760b576296eb4d78a6",
    ("gf64", "outside"):
        "cd9a5e6f0c99ba6be1f7f9026a8e7e70ecf2e96711a6e9c35f8feb43f7f19df0",
    ("gf64", "inside"):
        "a7171c4c6076c073b8b036dafd6be3d6de58d285264b4704e54311d8e246b7db",
    ("gf192", "outside"):
        "ba8053cbe370ae0bb322436a27d9206ee9af9862b33a89a23972a8a8ae693500",
    ("gf192", "inside"):
        "39cb607a8937fad52feb4784a1eb6de5fff3c86a9216f766809a9a997af361f2",
}


def _reference_domains(name):
    """tests/test_bivariate.py:20-27's (F, S, L) in the JAX package."""
    RF = FIELDS[name][1]()
    if RF.kind == "additive":
        return RF, RefSubspace(RF, 3), RefSubspace(RF, 5, shift=1 << 40)
    return (RF, RefCoset(RF, 3),
            RefCoset(RF, 5, shift=RF.multiplicative_generator))


def _points(F, L):
    """x outside L (the reference test's draw) and x inside L (its element
    13)."""
    x = F.sample_int(int.from_bytes(np.random.default_rng(9).bytes(40),
                                    "little"))
    return {"outside": x, "inside": L.element_by_index_int(13)}


def _digest(arr) -> str:
    return hashlib.sha256(np.asarray(arr).astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_bivariate_matches_reference(name):
    """evaluations_over gives the JAX package's limbs (pinned) with x off
    and on L, and agrees with the pointwise values; evaluation_at_point_int
    (the diagonal too) and fix_x equal the JAX package's, live."""
    RF, RS, RL = _reference_domains(name)
    F = FIELDS[name][0]()
    S, L = domain_from_reference(F, RS), domain_from_reference(F, RL)
    f, rf = BivariateLagrange(S), ref_bivariate.BivariateLagrange(RS)
    for tag, x in _points(F, L).items():
        assert index_of_element(L, x) == (13 if tag == "inside" else -1)
        out = f.evaluations_over(x, L, device="cpu")
        assert out.shape == (F.L, L.order)
        assert _digest(limbs_to_numpy(out)) == PINS[(name, tag)], tag
        vals = F.to_ints(out)
        for i in range(L.order):
            y = L.element_by_index_int(i)
            assert int(vals[i]) == f.evaluation_at_point_int(x, y) == \
                rf.evaluation_at_point_int(x, y)
    rng = np.random.default_rng(7)
    for _ in range(4):
        x, y = (F.sample_int(int.from_bytes(rng.bytes(40), "little"))
                for _ in range(2))
        assert f.evaluation_at_point_int(x, y) == rf.evaluation_at_point_int(x, y)
        assert f.evaluation_at_point_int(x, x) == rf.evaluation_at_point_int(x, x)
    c = F.sample_int(int.from_bytes(np.random.default_rng(10).bytes(40),
                                    "little"))
    assert f.fix_x(c) == rf.fix_x(c)
    s = S.element_by_index_int(5)
    assert f.fix_x(s) == rf.fix_x(s)


def test_basis_utilities_match_reference():
    for name in ("edwards_Fr", "gf64"):
        F, RF = FIELDS[name][0](), FIELDS[name][1]()
        for dim, lo in ((4, 0), (3, 5)):
            assert monomial_basis(F, dim, lo) == \
                ref_bivariate.monomial_basis(RF, dim, lo)
        basis = monomial_basis(F, 4, 1)
        sq = lambda v: F.mul_ints(v, v)  # noqa: E731
        assert transform_basis_by_polynomial(sq, basis) == \
            ref_bivariate.transform_basis_by_polynomial(sq, basis)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_reference_evaluations_over_give_the_pins(name):
    """The JAX package's evaluations_over hashes to the pins and equals the
    port's limbs."""
    RF, RS, RL = _reference_domains(name)
    F = FIELDS[name][0]()
    S, L = domain_from_reference(F, RS), domain_from_reference(F, RL)
    for tag, x in _points(F, L).items():
        want = np.asarray(ref_bivariate.BivariateLagrange(RS).evaluations_over(
            x, RL))
        assert _digest(want) == PINS[(name, tag)]
        got = BivariateLagrange(S).evaluations_over(x, L, device="cpu")
        np.testing.assert_array_equal(limbs_to_numpy(got), want)
