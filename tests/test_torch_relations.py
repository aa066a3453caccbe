"""Port vs reference: R1CS example generation and the sparse matvecs (ELL
plan through kernel K7's wrapper, and the segment-sum fallback).
Tolerance 0."""
import numpy as np
import pytest

import libiop_tpu_torch.relations.sparse as port_sparse

from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.relations.examples import \
    generate_r1cs_example as jax_generate
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.interop import (limbs_from_numpy, limbs_to_numpy,
                                      r1cs_from_reference)
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations.variable import Variable
from torch_one_thread import one_torch_thread  # noqa: F401

Fj, Ft = jax_edwards_fr(), edwards_fr()


def _pair(seed, m=16, k=3, n=15):
    cj, pj, aj = jax_generate(Fj, m, k, n, np.random.default_rng(seed))
    ct, pt, at = generate_r1cs_example(Ft, m, k, n, np.random.default_rng(seed))
    return (cj, pj, aj), (ct, pt, at)


def test_example_generation_matches_reference():
    (cj, pj, aj), (ct, pt, at) = _pair(424242)
    assert (pt, at) == (pj, aj)
    assert ct.constraints == cj.constraints
    assert r1cs_from_reference(Ft, 3, 15, cj.constraints).constraints == \
        ct.constraints
    assert ct.is_satisfied(pt, at)


@pytest.mark.parametrize("segsum", [False, True])
def test_matvecs_match_reference(segsum, monkeypatch):
    real, ell_calls = port_sparse.ell_matvec, []

    def spy(*args):
        ell_calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(port_sparse, "ell_matvec", spy)
    (cj, pj, aj), (ct, pt, at) = _pair(7, m=32, k=3, n=31)
    rng = np.random.default_rng(8)
    z = Fj.from_ints_np([1] + list(pj) + list(aj))
    y = Fj.from_ints_np(Ft.random_ints(32, rng))
    for Mj, Mt in zip(cj.matrices(), ct.matrices()):
        if segsum:  # the reference falls back to segment_sum without a plan
            Mj._mv_plan = None
            Mj._mvT_plan = None
        np.testing.assert_array_equal(
            limbs_to_numpy(Mt.matvec(limbs_from_numpy(z), force_segsum=segsum)),
            np.asarray(Mj.matvec(z)))
        np.testing.assert_array_equal(
            limbs_to_numpy(Mt.matvec_transpose(limbs_from_numpy(y),
                                               force_segsum=segsum)),
            np.asarray(Mj.matvec_transpose(y)))
    assert len(ell_calls) == (0 if segsum else 6)


def test_variable_expressions_normalize_like_raw_pairs():
    x1, x2 = Variable(1), Variable(2)
    ct = generate_r1cs_example(Ft, 4, 1, 3, np.random.default_rng(1))[0]
    ct.add_constraint(x1 * 3 + x2 - 2, x2, [(1, 1)])
    assert ct.constraints[-1] == ([(0, -2), (1, 3), (2, 1)], [(2, 1)],
                                  [(1, 1)])
