"""The port's Lagrange basis of a domain at a point against the reference:
lagrange_coefficients_any (kernel K25's plain twin on the CPU) over
edwards_Fr, alt_bn128_Fr, GF(2^64) and GF(2^192) on the canonical domains
of dimension 3 and 6, with alpha off the domain and alpha = h_2, and
poly.lagrange_coefficients at a device alpha on tests/test_algebra.py:75-97's
coset (dimension 3, shift 19).  PINS are the sha256s of the JAX package's
limbs (or words), which the slow test recomputes; the properties
(interpolation, partition of unity, the one-hot case) are checked on the
port's values.  Tolerance 0."""
import hashlib

import numpy as np
import pytest

from libiop_tpu.algebra import generic as ref_generic
from libiop_tpu.algebra import poly as ref_poly
from libiop_tpu.algebra.domains import MultiplicativeCoset as RefCoset
from libiop_tpu.fields import binary as ref_binary
from libiop_tpu.fields import prime as ref_prime
from libiop_tpu_torch.algebra import poly
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.algebra.generic import (horner_eval_ints,
                                              lagrange_coefficients_any,
                                              make_domain)
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import domain_from_reference, limbs_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (edwards_fr, ref_prime.edwards_fr),
          "alt_bn128_Fr": (alt_bn128_fr, ref_prime.alt_bn128_fr),
          "gf64": (binary.gf64, ref_binary.gf64),
          "gf192": (binary.gf192, ref_binary.gf192)}

#: (field, dim, "off" | "on") -> sha256 of the JAX package's
#: lagrange_coefficients_any(make_domain(F, dim), alpha) as little-endian
#: uint32 limbs or words
PINS = {
    ("alt_bn128_Fr", 3, "off"):
        "e1db24b13eac5a48aa45b607ef7cac7eddac1925b05ff7e1aab809759d798f74",
    ("alt_bn128_Fr", 3, "on"):
        "0f18bc0881c295545d3bb15c33d003cd08410b042b477b414d2f0ad474404953",
    ("alt_bn128_Fr", 6, "off"):
        "6064594256621d69de64df4c6a625a812270bc12fae38c41d576b6c3ceb5c51c",
    ("alt_bn128_Fr", 6, "on"):
        "a6464f47f8b434441d43f5c0b16b9e1df037b0faa878920bee01d980d56761f5",
    ("edwards_Fr", 3, "off"):
        "a0d4784703d482f414ff51e8a3a0e73969b60a2abb8747ae3c3d354b2360b0dd",
    ("edwards_Fr", 3, "on"):
        "a1ff6848ec5dab77639f6b2b1b2cf4eae6e3122c43c881115c674ca64b288c2b",
    ("edwards_Fr", 6, "off"):
        "44818778a0b338360290c4bc01db74927aab11bb70f77e17c2a6c31861d29690",
    ("edwards_Fr", 6, "on"):
        "8d648f932caf3d191b01016b8cebfbc4ead6fb042937188877cc7074f4f329e0",
    ("gf192", 3, "off"):
        "160717db123d8073f7e9adcedb5c8e4bc66de6c3b90622aedabcddeb66f4178b",
    ("gf192", 3, "on"):
        "1334484bcfc116c510a89089319dcdc4f6e9cfd2a789669b59ce577fe3ea238a",
    ("gf192", 6, "off"):
        "1f4586b13d2a1c05ed952c69bb75d8a1a6249b8f11c8d20ef67e1ee60a2f66cf",
    ("gf192", 6, "on"):
        "3296ca5f9ca4b7629a8f83d3419f79316836fa9a33780485549558e6e006f78a",
    ("gf64", 3, "off"):
        "302f5af4f254e2808a9ab74b23ba68fccb8fb684d8eb7d6deca4613f086b4a0c",
    ("gf64", 3, "on"):
        "6e384b20006c687fe6183a443d7f15691a4d81be5fe39d8acb8d9ef7a8238117",
    ("gf64", 6, "off"):
        "fb76f0d4ffacedd699365415e17df8cee8876607e225a992268d3728b5fbc9c1",
    ("gf64", 6, "on"):
        "654570c81dcaf412c191946f70e20a3e8e11c7968e3a891f98ac679189db0fff",
}
#: "off" | "on" -> sha256 of the JAX package's poly.lagrange_coefficients on
#: the coset of dimension 3 and shift 19 over edwards_Fr
POLY_PINS = {
    "off": "f87027aca000b0ab8b8e61d2f30789772387979cbdceee09bca830da01df43e9",
    "on": "a1ff6848ec5dab77639f6b2b1b2cf4eae6e3122c43c881115c674ca64b288c2b",
}
CASES = [(name, dim) for name in sorted(FIELDS) for dim in (3, 6)]


def _digest(arr) -> str:
    return hashlib.sha256(np.asarray(arr).astype("<u4").tobytes()).hexdigest()


def _alphas(F, H, seed):
    """alpha off H (drawn from the seed) and alpha = h_2."""
    off = F.sample_int(int.from_bytes(np.random.default_rng(seed).bytes(40),
                                      "little"))
    return {"off": off, "on": H.element_by_index_int(2)}


def _check_properties(F, H, alpha, coeffs, rng):
    """Interpolation of a random polynomial of degree < |H|, partition of
    unity, and the one-hot vector when alpha is in H, on host ints."""
    got = [int(v) for v in F.to_ints(coeffs)]
    elems = [H.element_by_index_int(k) for k in range(H.order)]
    f = F.random_ints(H.order, rng)
    interp = 0
    for k in range(H.order):
        interp = F.add_ints(interp, F.mul_ints(got[k],
                                               horner_eval_ints(F, f, elems[k])))
    assert interp == horner_eval_ints(F, f, alpha)
    total = 0
    for v in got:
        total = F.add_ints(total, v)
    assert total == 1
    if alpha in elems:
        assert got == [int(e == alpha) for e in elems]


@pytest.mark.parametrize("name,dim", CASES)
def test_lagrange_coefficients_any_matches_reference(name, dim):
    F = FIELDS[name][0]()
    H = make_domain(F, dim)
    rng = np.random.default_rng(11)
    for tag, alpha in _alphas(F, H, dim).items():
        out = lagrange_coefficients_any(H, alpha, device="cpu")
        assert out.shape == (F.L, H.order)
        assert _digest(limbs_to_numpy(out)) == PINS[(name, dim, tag)], tag
        _check_properties(F, H, alpha, out, rng)


def test_poly_lagrange_coefficients_matches_reference():
    F = edwards_fr()
    H = MultiplicativeCoset(F, 3, shift=19)
    rng = np.random.default_rng(12)
    for tag, alpha in _alphas(F, H, 3).items():
        out = poly.lagrange_coefficients(
            H, F.from_ints([alpha], "cpu").reshape(F.L))
        assert _digest(limbs_to_numpy(out)) == POLY_PINS[tag], tag
        _check_properties(F, H, alpha, out, rng)


@pytest.mark.slow
@pytest.mark.parametrize("name,dim", CASES)
def test_reference_lagrange_coefficients_give_the_pins(name, dim):
    F, RF = FIELDS[name][0](), FIELDS[name][1]()
    RH = ref_generic.make_domain(RF, dim)
    H = domain_from_reference(F, RH)
    for tag, alpha in _alphas(F, H, dim).items():
        want = np.asarray(ref_generic.lagrange_coefficients_any(RH, alpha))
        assert _digest(want) == PINS[(name, dim, tag)]
        got = lagrange_coefficients_any(H, alpha, device="cpu")
        np.testing.assert_array_equal(limbs_to_numpy(got), want)


@pytest.mark.slow
def test_reference_poly_lagrange_coefficients_give_the_pins():
    RF = ref_prime.edwards_fr()
    RH = RefCoset(RF, 3, shift=19)
    for tag, alpha in _alphas(edwards_fr(), RH, 3).items():
        want = np.asarray(ref_poly.lagrange_coefficients(
            RH, RF.from_ints([alpha]).reshape(RF.L)))
        assert _digest(want) == POLY_PINS[tag]
