"""Port vs reference: the multiplicative FRI fold (eta = 1, 2, 3) on a coset,
and the verifier's host-int coset interpolation.  Tolerance 0.  The
reference's folds cost an XLA CPU compile each: tier 1 holds the port's to
the sha256 of the reference's (``FOLD_PINS``) and the slow test recomputes
them."""
import hashlib

import numpy as np
import pytest

from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.protocols import fri as jfri
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.interop import limbs_to_numpy
from libiop_tpu_torch.protocols import fri
from torch_one_thread import one_torch_thread  # noqa: F401


#: sha256 of the reference's fold (little-endian uint32 limbs) per eta;
#: the slow test recomputes them
FOLD_PINS = {
    1: "840a086d87263da8d9024da342456dea812566249a01dea29390fd4d1c10a3c8",
    2: "18e03e5a60a5c901f035734f75e576dcbe70323a34c5308c5106b2b7cdc798db",
    3: "8b97102e9f8c101e80c7426f518ed5034a8ae484993507261a2ed5060a413a5c",
}


def _fold_case(eta):
    Ft = edwards_fr()
    rng = np.random.default_rng(eta)
    ints = Ft.random_ints(1 << 6, rng)
    return ints, Ft.random_ints(1, rng)[0]


def _fold_reference(eta):
    Fj = jax_edwards_fr()
    ints, x = _fold_case(eta)
    dj = JaxCoset(Fj, 6, Fj.multiplicative_generator)
    return np.asarray(jfri.fold_codeword(Fj, Fj.from_ints_np(ints), dj, eta,
                                         x))


def _fold_port(eta):
    Ft = edwards_fr()
    ints, x = _fold_case(eta)
    dt = MultiplicativeCoset(Ft, 6, Ft.multiplicative_generator)
    return fri.fold_codeword(Ft, Ft.from_ints(ints, "cpu"), dt, eta, x)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).astype("<u4").tobytes()
                          ).hexdigest()


@pytest.mark.parametrize("eta", [1, 2, 3])
def test_fold_codeword_matches_reference(eta):
    """The fold held to the reference's pin; the verifier's host-int coset
    interpolation against the fold and against the reference's, live."""
    Fj, Ft = jax_edwards_fr(), edwards_fr()
    got = _fold_port(eta)
    assert _digest(limbs_to_numpy(got)) == FOLD_PINS[eta]
    ints, x = _fold_case(eta)
    dt = MultiplicativeCoset(Ft, 6, Ft.multiplicative_generator)
    c = 1 << eta
    nc = dt.order // c
    folded = Ft.to_ints(got)
    for j in (0, nc - 1):
        coset_vals = [ints[j + k * nc] for k in range(c)]
        shift = dt.element_by_index_int(j)
        assert fri.interpolate_coset_at_point_ints(
            Ft, coset_vals, shift, eta, x) == folded[j] == \
            jfri.interpolate_coset_at_point_ints(Fj, coset_vals, shift, eta, x)


@pytest.mark.slow
def test_fold_reference_outputs_behind_the_pins():
    for eta in (1, 2, 3):
        want = _fold_reference(eta)
        np.testing.assert_array_equal(limbs_to_numpy(_fold_port(eta)), want)
        assert _digest(want) == FOLD_PINS[eta], eta
