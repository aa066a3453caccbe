"""Port vs reference: R1CS example generation, the sparse matvecs (ELL
plan through kernel K7's wrapper, and the segment-sum fallback), and the
constraint DSL (tests/test_relations.py:47-91's assertions on the port, and
the JAX package's relations/variable.py, which imports no JAX, compared
live).  Tolerance 0."""
import numpy as np
import pytest

import libiop_tpu_torch.relations.sparse as port_sparse

from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.relations import variable as ref_variable
from libiop_tpu.relations.examples import \
    generate_r1cs_example as jax_generate
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.interop import (limbs_from_numpy, limbs_to_numpy,
                                      r1cs_from_reference)
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations import variable
from libiop_tpu_torch.relations.r1cs import R1CS
from libiop_tpu_torch.relations.variable import (LinearCombination,
                                                 LinearTerm, Variable,
                                                 as_term_pairs)
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


def test_variable_dsl_arithmetic(rng):
    """tests/test_relations.py:47-91 on the port: like-term merging, int
    constants, scalar multiply, negation, rsub, add_term, is_valid, a
    hand-built circuit and evaluate()."""
    F = Ft
    x, y, z, w = Variable(1), Variable(2), Variable(3), Variable(4)

    lc = 2 * x + y - 3
    assert as_term_pairs(lc) == [(0, -3), (1, 2), (2, 1)]
    assert as_term_pairs(lc + x) == [(0, -3), (1, 3), (2, 1)]
    assert as_term_pairs(lc - 2 * x - y + 3) == []
    assert as_term_pairs(5 - x) == [(0, 5), (1, -1)]
    assert as_term_pairs(-(x * 4)) == [(1, -4)]
    assert (x + y) * 2 == LinearCombination([LinearTerm(1, 2),
                                             LinearTerm(2, 2)])
    lc2 = LinearCombination()
    lc2.add_term(x, 7)
    lc2.add_term(y)
    lc2.add_term(-2)
    assert as_term_pairs(lc2) == [(0, -2), (1, 7), (2, 1)]
    assert lc2.is_valid(4) and not LinearCombination(Variable(9)).is_valid(4)

    # circuit: (x + 2y) * (3z - 1) = w ; (w - 5) * x = y
    cs = R1CS(F, num_inputs=2, num_variables=4)
    cs.add_constraint(x + 2 * y, 3 * z - 1, w)
    cs.add_constraint(w - 5, x, y)
    p = F.p
    xv, zv = int(rng.integers(2, 1 << 60)), int(rng.integers(2, 1 << 60))
    a = (2 * (3 * zv - 1) - pow(xv, p - 2, p)) % p
    yv = ((5 - xv * (3 * zv - 1)) * pow(a, p - 2, p)) % p
    wv = (yv * pow(xv, p - 2, p) + 5) % p
    assert cs.is_satisfied([xv, yv], [zv, wv])
    assert not cs.is_satisfied([xv, (yv + 1) % p], [zv, wv])
    assert (x + 2 * y).evaluate([xv, yv, zv, wv], p) == (xv + 2 * yv) % p


def _both(build):
    """build(module) in the port's DSL and in the JAX package's."""
    return build(variable), build(ref_variable)


@pytest.mark.parametrize("case", [
    "sum", "rsub", "radd_term", "eq_hash", "repr", "evaluate", "is_valid",
    "iter"])
def test_variable_dsl_matches_reference(case):
    """The port's DSL against the JAX package's relations/variable.py,
    live: sum() from 0, an int on the left of - and +, value equality and
    hashing, repr strings, evaluate and is_valid."""
    p = Ft.p

    def build(m):
        V, T, LC = m.Variable, m.LinearTerm, m.LinearCombination
        x, y = V(1), V(2)
        if case == "sum":
            return [m.as_term_pairs(sum([V(1), V(2), V(3)])),
                    m.as_term_pairs(sum([T(1, 3), T(1, 4), 2 * y]))]
        if case == "rsub":
            return [m.as_term_pairs(5 - V(2)), m.as_term_pairs(5 - T(2, 3)),
                    m.as_term_pairs(5 - (x + y))]
        if case == "radd_term":
            return [m.as_term_pairs(7 + x), m.as_term_pairs(7 + T(1, 2)),
                    m.as_term_pairs(7 + (x - y))]
        if case == "eq_hash":
            return [V(1) == V(1), V(1) == V(2), hash(V(1)) == hash(V(1)),
                    T(1, 2) == T(1, 2), T(1, 2) == T(1, 3),
                    hash(T(1, 2)) == hash(T(1, 2)),
                    x + y == y + x, x + y - y == LC(x),
                    hash(x + y) == hash(y + x), len({V(3), V(3), V(4)}),
                    (x + y).__eq__(3) is NotImplemented]
        if case == "repr":
            return [repr(V(0)), repr(V(5)), repr(T(0, 3)), repr(T(2, 1)),
                    repr(T(2, -4)), repr(2 * x + y - 3), repr(LC())]
        if case == "evaluate":
            return [(3 * x - 2 * y + 9).evaluate([10, 4], p),
                    (x - 3 * y).evaluate([1, 1], p), LC().evaluate([], p)]
        if case == "is_valid":
            return [(x + V(4)).is_valid(4), (x + V(5)).is_valid(4),
                    LC(V(0)).is_valid(0), LC().is_valid(0)]
        return [[(t.index, t.coeff) for t in 2 * x - y + 1],
                [(t.index, t.coeff) for t in LC([x, T(2, 3), 4])]]

    port, ref = _both(build)
    assert port == ref


def test_variable_expressions_keep_the_r1cs_pairs():
    """The pairs add_constraint stores for each kind of argument equal the
    JAX package's (its R1CS container normalizes through as_term_pairs)."""
    def build(m):
        x, y = m.Variable(1), m.Variable(2)
        return [m.as_term_pairs(e) for e in (
            x * 3 + y - 2, 5 - y, sum([x, y, x]), -(y * 4) + 0, x, y * 2,
            [(1, 1)], 7)]

    port, ref = _both(build)
    assert port == ref
