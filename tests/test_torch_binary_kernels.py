"""Port vs reference over binary fields for the pieces the Fractal path
adds, on small inputs made from seeded numpy generators, tolerance 0
(exact words): the subspace Lagrange family (p_alpha over a domain and at
a point, alpha included) and the linearized formal derivative; the
additive rational sumcheck's constraint oracle; the GF(2^k) twins of K7
(sparse matvec), K10 (Horner), K11 (power table) and K21 (p_alpha * M)
against SparseMatrix.matvec / matvec_transpose, horner_eval,
device_powers and compute_p_alpha_M_evals, over gf64 live and over gf192
through sha256 pins of the JAX outputs (recomputed by the slow test); and
the four wrappers' shape and dtype checks.  Each JAX function here is one
small XLA CPU compile, with no prover."""
import hashlib

import numpy as np
import pytest
import torch

from libiop_tpu.algebra import generic as jax_generic
from libiop_tpu.algebra.domains import device_powers as jax_device_powers
from libiop_tpu.algebra.poly import horner_eval as jax_horner_eval
from libiop_tpu.algebra.subspace import AffineSubspace as JaxSubspace
from libiop_tpu.fields import binary as jax_binary
from libiop_tpu.protocols import holographic_lincheck as jax_hl
from libiop_tpu.protocols import rational_sumcheck as jax_rs
from libiop_tpu.relations.examples import \
    generate_r1cs_example as jax_example
from libiop_tpu_torch.algebra import generic
from libiop_tpu_torch.algebra.domains import device_powers
from libiop_tpu_torch.algebra.poly import horner_eval
from libiop_tpu_torch.algebra.subspace import AffineSubspace
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.kernels.ell_matvec import ell_matvec
from libiop_tpu_torch.kernels.horner import horner
from libiop_tpu_torch.kernels.p_alpha_m import p_alpha_m
from libiop_tpu_torch.kernels.powers import powers
from libiop_tpu_torch.protocols import holographic_lincheck as hl
from libiop_tpu_torch.protocols.rational_sumcheck import \
    SumcheckConstraintOracle
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("gf64", "gf192")


def _fields(name):
    return getattr(jax_binary, name)(), getattr(binary, name)()


def _words(F, shape, rng):
    """Uniform elements as (W, *shape) uint32 words."""
    return rng.integers(0, 1 << 32, size=(F.W,) + tuple(shape),
                        dtype=np.uint64).astype(np.uint32)


def test_subspace_lagrange_family_matches_reference():
    """GF(2^64), H a 2^4 subspace inside L, a shifted 2^6 one: p_alpha over
    L, p_alpha at a point of L and at alpha itself (the derivative eps),
    and the formal derivatives of Z_H and Z_L."""
    Fj, Ft = _fields("gf64")
    rng = np.random.default_rng(30)
    alpha, x = Ft.random_ints(2, rng)
    shift = 1 << 50
    Hj, Ht = JaxSubspace(Fj, 4), AffineSubspace(Ft, 4)
    Lj, Lt = JaxSubspace(Fj, 6, shift), AffineSubspace(Ft, 6, shift)
    want = np.asarray(jax_generic.lagrange_poly_evals_over_any(Hj, alpha, Lj))
    got = generic.lagrange_poly_evals_over_any(Ht, alpha, Lt, "cpu")
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    on_L = Lt.element_by_index_int(5)
    for point in (x, on_L, alpha):
        assert generic.lagrange_poly_eval_at_point_int_any(Ht, alpha, point) \
            == jax_generic.lagrange_poly_eval_at_point_int_any(Hj, alpha,
                                                               point)
    for Dj, Dt in ((Hj, Ht), (Lj, Lt)):
        assert generic.linearized_vanishing(Dt).formal_derivative() == \
            jax_generic.linearized_vanishing(Dj).formal_derivative()


def test_additive_sumcheck_constraint_oracle_matches_reference():
    """The rational sumcheck's constraint over a 2^3 subspace K inside a
    shifted 2^5 codeword domain, GF(2^64): its values over L and at three
    points, for one claimed sum."""
    Fj, Ft = _fields("gf64")
    rng = np.random.default_rng(31)
    shift = 1 << 40
    Kj, Kt = JaxSubspace(Fj, 3), AffineSubspace(Ft, 3)
    Lj, Lt = JaxSubspace(Fj, 5, shift), AffineSubspace(Ft, 5, shift)
    mu = Ft.random_ints(1, rng)[0]
    evals = [_words(Ft, (32,), rng) for _ in range(3)]
    oj = jax_rs.SumcheckConstraintOracle(Fj, Kj, Lj)
    ot = SumcheckConstraintOracle(Ft, Kt, Lt)
    oj.set_claimed_sum(mu)
    ot.set_claimed_sum(mu)
    want = np.asarray(oj.evaluated_contents(evals))
    got = ot.evaluated_contents([limbs_from_numpy(e) for e in evals])
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    ints = [Ft.to_ints(limbs_from_numpy(e)) for e in evals]
    for pos in (0, 7, 31):
        x = Lt.element_by_index_int(pos)
        vals = [int(v[pos]) for v in ints]
        assert ot.evaluation_at_point(pos, x, vals) == \
            oj.evaluation_at_point(pos, x, vals)


# -- the four twins: live against the JAX package over gf64; over gf192
# against sha256 pins of the JAX outputs (its gf192 compiles would double
# this file's clock), which the slow test recomputes live ------------------

def _ell_matvec_cases(name):
    """[(port words, JAX thunk)]: M z and M^T z of the example's A, B, C at
    16 constraints, on the ELL route and on the segment route (K21's CSR
    walk, which matrices too skewed for an ELL plan take)."""
    Fj, Ft = _fields(name)
    cs_j, _, _ = jax_example(Fj, 16, 3, 15, np.random.default_rng(32))
    cs_t, _, _ = generate_r1cs_example(Ft, 16, 3, 15,
                                       np.random.default_rng(32))
    z = _words(Ft, (16,), np.random.default_rng(33))
    out = []
    for Mj, Mt in zip(cs_j.matrices(), cs_t.matrices()):
        for op in ("matvec", "matvec_transpose"):
            for segsum in (False, True):
                out.append((getattr(Mt, op)(limbs_from_numpy(z),
                                            force_segsum=segsum),
                            lambda Mj=Mj, op=op: getattr(Mj, op)(z)))
    return out


def _horner_cases(name):
    """d = 300 (blocked) at 7 points and d = 5 at one point."""
    Fj, Ft = _fields(name)
    rng = np.random.default_rng(34)
    out = []
    for d, k in ((300, 7), (5, 1)):
        coeffs, x = _words(Ft, (d,), rng), _words(Ft, (k,), rng)
        out.append((horner_eval(Ft, limbs_from_numpy(coeffs),
                                limbs_from_numpy(x)),
                    lambda c=coeffs, x=x: jax_horner_eval(Fj, c, x)))
    return out


def _powers_cases(name):
    """32 powers of a random element."""
    Fj, Ft = _fields(name)
    x = _words(Ft, (), np.random.default_rng(35))
    return [(device_powers(Ft, limbs_from_numpy(x), 32),
             lambda: jax_device_powers(Fj, x, 32))]


def _p_alpha_m_cases(name):
    """compute_p_alpha_M_evals over a 2^4 subspace (16 constraints, 3
    inputs), p_alpha over H from the port's lagrange_poly_evals_over_any."""
    Fj, Ft = _fields(name)
    cs_j, _, _ = jax_example(Fj, 16, 3, 15, np.random.default_rng(36))
    cs_t, _, _ = generate_r1cs_example(Ft, 16, 3, 15,
                                       np.random.default_rng(36))
    rng = np.random.default_rng(37)
    alpha = Ft.random_ints(1, rng)[0]
    r = Ft.random_ints(3, rng)
    Ht = AffineSubspace(Ft, 4)
    p_alpha = generic.lagrange_poly_evals_over_any(Ht, alpha, Ht, "cpu")
    got = hl.compute_p_alpha_M_evals(Ft, 2, Ht, p_alpha, r,
                                     list(cs_t.matrices()))
    return [(got, lambda: jax_hl.compute_p_alpha_M_evals(
        Fj, 2, JaxSubspace(Fj, 4), limbs_to_numpy(p_alpha), r,
        list(cs_j.matrices())))]


CASES = {"ell_matvec": _ell_matvec_cases, "horner": _horner_cases,
         "powers": _powers_cases, "p_alpha_m": _p_alpha_m_cases}

#: twin -> sha256 of the JAX package's gf192 outputs, case after case
GF192_PINS = {
    "ell_matvec":
        "f8ee2644b8e8109b44d56f6ad1ce61b04c96a7fbbcebd539e261c7a58bcf5245",
    "horner":
        "5e5a79547acc3488578977bed4fb75717c92c30a75922c8e0f9d31ae0c849b43",
    "powers":
        "d752b432b43355c342efb527e241e56bb7dfca2d92e22430fac7931c8be72add",
    "p_alpha_m":
        "2e97418e311702a0f4ea1d285653e21b685ffc72b32e2df22293c982d8249e97"}


def _digest(arrays) -> str:
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).tobytes()
        for a in arrays)).hexdigest()


def _check_twin(kernel):
    for got, want in CASES[kernel]("gf64"):
        np.testing.assert_array_equal(limbs_to_numpy(got),
                                      np.asarray(want()))
    assert _digest(limbs_to_numpy(got) for got, _ in
                   CASES[kernel]("gf192")) == GF192_PINS[kernel]


def test_ell_matvec_twin_matches_reference():
    """K7's GF(2^k) twin through SparseMatrix.matvec and matvec_transpose,
    and the segment route (see _ell_matvec_cases)."""
    _check_twin("ell_matvec")


def test_horner_twin_matches_reference():
    """K10's GF(2^k) twin through horner_eval."""
    _check_twin("horner")


def test_powers_twin_matches_reference():
    """K11's GF(2^k) twin through device_powers; start * x^i against host
    ints over both fields."""
    _check_twin("powers")
    for name in FIELDS:
        Ft = getattr(binary, name)()
        xi, s = Ft.random_ints(2, np.random.default_rng(39))
        got = powers(Ft, Ft.from_ints([xi], "cpu").reshape(Ft.W),
                     9, Ft.from_ints([s], "cpu").reshape(Ft.W))
        assert list(Ft.to_ints(got)) == [Ft.mul_ints(s, Ft.pow_int(xi, i))
                                         for i in range(9)]


def test_p_alpha_m_twin_matches_reference():
    """K21's GF(2^k) twin through compute_p_alpha_M_evals."""
    _check_twin("p_alpha_m")


@pytest.mark.slow
def test_reference_gives_gf192_pins():
    """The JAX package's gf192 outputs behind GF192_PINS."""
    for kernel, cases in CASES.items():
        assert _digest(np.asarray(want()) for _, want in cases("gf192")) \
            == GF192_PINS[kernel], kernel


def test_binary_wrappers_check_shapes_and_dtypes():
    """The four wrappers refuse a wrong dtype, word count or shape over
    GF(2^64), and K7 gives zero for a row of only padding."""
    F = binary.gf64()
    rng = np.random.default_rng(38)
    vals = limbs_from_numpy(np.concatenate(
        [_words(F, (4,), rng), np.zeros((F.W, 1), np.uint32)], axis=1))
    vec = limbs_from_numpy(_words(F, (3,), rng))
    entry = torch.tensor([0, 1, 4, 4, 2, 3], dtype=torch.int64)
    src = torch.tensor([0, 2, 0, 0, 1, 1], dtype=torch.int64)
    out = ell_matvec(F, vals, entry, src, vec, 2)
    assert out.shape == (F.W, 3) and not out[:, 1].any()
    with pytest.raises(ValueError):
        ell_matvec(F, vals, entry.to(torch.int32), src, vec, 2)
    with pytest.raises(ValueError):
        ell_matvec(F, vals[:1].contiguous(), entry, src, vec, 2)
    with pytest.raises(TypeError):
        horner(F, vec.to(torch.int64), vec)
    with pytest.raises(ValueError):
        horner(F, vec, vec[0].contiguous())
    with pytest.raises(ValueError):
        powers(F, vec, 4)
    with pytest.raises(ValueError):
        powers(F, vec[:, 0].contiguous(), -1)
    plan = (vals[:, :4].contiguous(), torch.tensor([0, 2, 4]),
            torch.tensor([0, 1, 2, 0]), 2)
    inv = torch.tensor([1, 0, 2], dtype=torch.int64)
    assert p_alpha_m(F, [plan], vec, [3], inv, 2).shape == (F.W, 3)
    with pytest.raises(ValueError):
        p_alpha_m(F, [plan], vec, [3, 4], inv, 2)
    with pytest.raises(ValueError):
        p_alpha_m(F, [plan], vec, [3], inv.to(torch.int32), 2)
