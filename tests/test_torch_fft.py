"""Port vs reference: NTT / inverse NTT over subgroups and cosets, including
the degree-aware sizes (d < N); vanishing division, Horner evaluation,
device powers and the domains' power tables over both fields.
Tolerance 0."""
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

Fj = jax_edwards_fr()
Ft = edwards_fr()
FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}


@pytest.mark.parametrize("N", [2, 8, 64, 256])
@pytest.mark.parametrize("coset", [False, True])
def test_fft_ifft_match_reference(N, coset):
    dim = N.bit_length() - 1
    shift = Ft.multiplicative_generator if coset else 1
    dj, dt = JaxCoset(Fj, dim, shift), MultiplicativeCoset(Ft, dim, shift)
    rng = np.random.default_rng(N + coset)
    d = max(1, N // 4)                       # degree-aware: d < N
    coeffs = Fj.from_ints_np(Ft.random_ints(d, rng))
    evals_j = np.asarray(jfft.fft(coeffs, dj))
    evals_t = fft.fft(limbs_from_numpy(coeffs), dt)
    np.testing.assert_array_equal(limbs_to_numpy(evals_t), evals_j)
    # the reference interpolates over the size-d subdomain: its ifft there
    coeffs_t = fft.ifft_of_known_degree(evals_t, dt, d)
    np.testing.assert_array_equal(
        limbs_to_numpy(coeffs_t),
        np.asarray(jfft.ifft_of_known_degree(evals_j, dj, d)))
    # full-size inverse: ifft(fft(c)) gives c padded with zeros
    padded = np.zeros((Ft.L, N), np.uint32)
    padded[:, :d] = coeffs
    np.testing.assert_array_equal(
        limbs_to_numpy(fft.ifft(evals_t, dt)), padded)


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
