"""Port vs reference: NTT / inverse NTT over subgroups and cosets, including
the degree-aware sizes (d < N); vanishing division, Horner evaluation,
device powers and the domains' power tables over both fields.
Tolerance 0.  The reference's transforms cost an XLA CPU compile each:
tier 1 holds the port's to the sha256 of the reference's outputs
(``FFT_PINS``) and the slow test recomputes them."""
import hashlib

import numpy as np
import pytest
import torch

from libiop_tpu.algebra import fft as jfft
from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.algebra import fft
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

Fj = jax_edwards_fr()
Ft = edwards_fr()
FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}


FFT_CASES = [(N, coset) for coset in (False, True) for N in (2, 8, 64, 256)]

#: sha256 of the reference's outputs per (N, coset): its evaluations of the
#: case's coefficients and its ifft_of_known_degree of them (little-endian
#: uint32 limbs); the slow test recomputes them
FFT_PINS = {
    (2, False):
        "0ee7439dce8b697391878c95346b946343886e0af8e1c27a35094a8c9e227258",
    (8, False):
        "5d91d014fa11fb2678ede8c6d4d1ebb7af06d995d8eda9884c1c46d00adb7d24",
    (64, False):
        "bbe2a900ce39bae6089a9632c7beb6f74ae67fd8c1507bdf755cdfe7f7fa5389",
    (256, False):
        "f49481f842d13fb9c33903d7226b04340a226b769a0421fbab785949197f0198",
    (2, True):
        "bc5d88943a85822a0094276583c733a0fb544048045134820bf31b98a764105c",
    (8, True):
        "466cd0926d8b268b97a24b48c01c91c2a36e892adc5f725825059cf9436889f1",
    (64, True):
        "140c573d598e306e8f58d2ad223fa5c0fb86a22d8d4cbedb285e14203296c1fb",
    (256, True):
        "91ac80518c89d758a305b1da402060bac8364fb9b8b1d94438380fd1111932c0",
}


def _digest(arrays):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).astype(
            "<u4").tobytes() for a in arrays)).hexdigest()


def _fft_case(N, coset):
    dim = N.bit_length() - 1
    shift = Ft.multiplicative_generator if coset else 1
    rng = np.random.default_rng(N + coset)
    d = max(1, N // 4)                       # degree-aware: d < N
    return dim, shift, d, Fj.from_ints_np(Ft.random_ints(d, rng))


def _fft_port(N, coset):
    """The port's evaluations and known-degree interpolation of the case;
    also checks that the full-size inverse gives the coefficients padded
    with zeros."""
    dim, shift, d, coeffs = _fft_case(N, coset)
    dt = MultiplicativeCoset(Ft, dim, shift)
    evals_t = fft.fft(limbs_from_numpy(coeffs), dt)
    padded = np.zeros((Ft.L, N), np.uint32)
    padded[:, :d] = coeffs
    np.testing.assert_array_equal(
        limbs_to_numpy(fft.ifft(evals_t, dt)), padded)
    return [limbs_to_numpy(evals_t),
            limbs_to_numpy(fft.ifft_of_known_degree(evals_t, dt, d))]


def _fft_reference(N, coset):
    dim, shift, d, coeffs = _fft_case(N, coset)
    dj = JaxCoset(Fj, dim, shift)
    evals_j = np.asarray(jfft.fft(coeffs, dj))
    # the reference interpolates over the size-d subdomain: its ifft there
    return [evals_j, np.asarray(jfft.ifft_of_known_degree(evals_j, dj, d))]


@pytest.mark.parametrize("N", [2, 8, 64, 256])
@pytest.mark.parametrize("coset", [False, True])
def test_fft_ifft_match_reference(N, coset):
    assert _digest(_fft_port(N, coset)) == FFT_PINS[(N, coset)]


@pytest.mark.slow
def test_fft_reference_outputs_behind_the_pins():
    for N, coset in FFT_CASES:
        want = _fft_reference(N, coset)
        for g, w in zip(_fft_port(N, coset), want):
            np.testing.assert_array_equal(g, w)
        assert _digest(want) == FFT_PINS[(N, coset)], (N, coset)


def test_fft_matches_naive_evaluation():
    dt = MultiplicativeCoset(Ft, 4, Ft.multiplicative_generator)
    ints = Ft.random_ints(5, np.random.default_rng(9))
    got = Ft.to_ints(fft.fft(Ft.from_ints(ints, "cpu"), dt))
    assert [int(v) for v in got] == fft.naive_fft_ints(ints, dt)


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("d", [37, 300])
def test_vanishing_division_and_horner_match_reference(d, field):
    """divide_by_vanishing against the reference's, mul_by_vanishing as its
    inverse, and horner_eval (blocked above 256 coefficients) against the
    reference's host-int Horner."""
    from libiop_tpu.algebra import poly as jpoly
    from libiop_tpu.algebra.generic import horner_eval_ints
    from libiop_tpu_torch.algebra import poly
    Fj, Ft = (f() for f in FIELDS[field])
    rng = np.random.default_rng(d)
    ints = Ft.random_ints(d, rng)
    Hj, Ht = JaxCoset(Fj, 3, 5), MultiplicativeCoset(Ft, 3, 5)
    q_t, r_t = poly.divide_by_vanishing(Ft.from_ints(ints, "cpu"), Ht)
    q_j, r_j = jpoly.divide_by_vanishing(Fj.from_ints_np(ints), Hj)
    np.testing.assert_array_equal(limbs_to_numpy(q_t), np.asarray(q_j))
    np.testing.assert_array_equal(limbs_to_numpy(r_t), np.asarray(r_j))
    back = Ft.add(poly.mul_by_vanishing(q_t, Ht)[:, :d],
                  torch.cat([r_t, Ft.zeros((d - 8,), "cpu")], dim=1))
    assert [int(v) for v in Ft.to_ints(back)] == ints
    xs = Ft.random_ints(3, rng)
    got = Ft.to_ints(poly.horner_eval(Ft, Ft.from_ints(ints, "cpu"),
                                      Ft.from_ints(xs, "cpu")))
    assert [int(v) for v in got] == [horner_eval_ints(Fj, ints, x) for x in xs]


def test_device_powers_matches_reference():
    """device_powers (K11's twin on the CPU) against the JAX package's
    (one small compile: three doublings)."""
    from libiop_tpu.algebra import domains as jdomains
    from libiop_tpu_torch.algebra import domains
    Fj, Ft = jax_alt_bn128_fr(), alt_bn128_fr()
    x = Ft.random_ints(1, np.random.default_rng(11))[0]
    want = np.asarray(jdomains.device_powers(
        Fj, Fj.from_ints_np([x]).reshape(Fj.L), 8))
    got = domains.device_powers(Ft, Ft.from_ints([x], "cpu").reshape(Ft.L), 8)
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_domain_tables_match_reference(field):
    """A coset's power tables (K11 on the card, its twin here) against the
    JAX package's, which it builds on the host (host_powers)."""
    Fj, Ft = (f() for f in FIELDS[field])
    dj = JaxCoset(Fj, 6, Fj.multiplicative_generator)
    dt = MultiplicativeCoset(Ft, 6, Ft.multiplicative_generator)
    for table in ("generator_powers", "inverse_generator_powers",
                  "shift_powers", "inverse_shift_powers", "inverse_elements"):
        np.testing.assert_array_equal(
            limbs_to_numpy(getattr(dt, table)("cpu")),
            np.asarray(getattr(dj, table)()), err_msg=table)
