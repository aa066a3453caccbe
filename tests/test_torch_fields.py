"""Port vs reference: prime-field arithmetic over edwards_Fr (12 limbs) and
alt_bn128_Fr (16 limbs).

The same canonical integers (numpy rng, plus 0, 1 and p-1) go through the
JAX package's PrimeField and the port's on the CPU; limbs must be equal
(tolerance 0: the arithmetic is exact).  The port's ops are checked to go
through the kernel wrappers (K1 mul, K5 add/sub/neg, K6 reductions, K20
inverse), whose plain twins are what the CPU runs."""
import numpy as np
import pytest
import torch
import jax

import libiop_tpu_torch.fields.prime as port_prime
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}


@pytest.fixture(params=sorted(FIELDS))
def fields(request):
    """(the JAX package's field, the port's) for each field."""
    return tuple(f() for f in FIELDS[request.param])

_WRAPPER = {"mul": "mont_mul", "square": "mont_mul", "inv": "batch_inv",
            "add": "field_addsub", "sub": "field_addsub",
            "neg": "field_addsub"}


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls PrimeField makes into each kernel wrapper."""
    calls = {}
    for name in ("mont_mul", "field_addsub", "lazy_reduce", "batch_inv"):
        fn = getattr(port_prime, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(port_prime, name, spy)
    return calls


def _operands(Fj, Ft, seed, n=61):
    rng = np.random.default_rng(seed)
    a = Ft.random_ints(n, rng) + [0, 1, Ft.p - 1, Ft.p - 1, 0]
    b = Ft.random_ints(n, rng) + [Ft.p - 1, Ft.p - 1, Ft.p - 1, 1, 0]
    return Fj.from_ints_np(a), Fj.from_ints_np(b), a


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops_match_reference(op, wrapper_calls, fields):
    Fj, Ft = fields
    a, b, _ = _operands(Fj, Ft, 1)
    want = np.asarray(getattr(Fj.j, op)(a, b))
    got = getattr(Ft, op)(limbs_from_numpy(a), limbs_from_numpy(b))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    assert wrapper_calls == {_WRAPPER[op]: 1}


@pytest.mark.parametrize("op", ["square", "neg", "inv"])
def test_unary_ops_match_reference(op, wrapper_calls, fields):
    Fj, Ft = fields
    a, _, ints = _operands(Fj, Ft, 2, n=13)
    want = np.asarray(getattr(Fj.j, op)(a))
    got = getattr(Ft, op)(limbs_from_numpy(a))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    assert set(wrapper_calls) == {_WRAPPER[op]}
    if op == "inv":
        assert Ft.to_ints(got)[ints.index(0)] == 0  # inv(0) = 0


def test_broadcast_scalar_mul_matches_reference(fields):
    Fj, Ft = fields
    L = Ft.L
    a, b, _ = _operands(Fj, Ft, 3, n=7)
    want = np.asarray(Fj.j.mul(a.reshape(L, 3, 4), b[:, :1].reshape(L, 1, 1)))
    got = Ft.mul(limbs_from_numpy(a.reshape(L, 3, 4)),
                 limbs_from_numpy(b[:, :1].reshape(L, 1, 1)))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


def _check_lazy_reductions(Fj, Ft, lazy, calls):
    assert lazy.max() < (1 << 28)
    lazy32 = lazy.astype(np.uint32)
    want_w = np.asarray(jax.jit(Fj.mont_reduce_wide)(lazy32))
    want_l = np.asarray(jax.jit(Fj.lazy_sum_reduce)(lazy32))
    lazy_t = torch.from_numpy(lazy.astype(np.int64))
    np.testing.assert_array_equal(limbs_to_numpy(Ft.mont_reduce_wide(lazy_t)),
                                  want_w)
    np.testing.assert_array_equal(limbs_to_numpy(Ft.lazy_sum_reduce(lazy_t)),
                                  want_l)
    assert calls == {"lazy_reduce": 2}


def test_mont_reduce_wide_near_column_bound(wrapper_calls, fields):
    """Lazy limb sums of 4096 canonical values (columns near 2^28, the
    reference's bound) reduce to the same limbs."""
    Fj, Ft = fields
    rng = np.random.default_rng(4)
    vals = np.stack([Fj.from_ints_np(Ft.random_ints(4096, rng))
                     for _ in range(3)], axis=1)            # (L, 3, 4096)
    vals[:, 0, :] = Fj.from_ints_np([Ft.p - 1] * 4096)
    _check_lazy_reductions(Fj, Ft, vals.astype(np.uint64).sum(axis=-1),
                           wrapper_calls)


def test_lazy_reductions_of_random_rows_match_reference(wrapper_calls,
                                                        fields):
    """20 rows of random columns below 2^28: more rows than a sum of field
    elements has (the value stays below p * R, where the reduction is
    exact)."""
    Fj, Ft = fields
    rng = np.random.default_rng(5)
    _check_lazy_reductions(
        Fj, Ft, rng.integers(0, 1 << 28, size=(20, 37), dtype=np.uint64),
        wrapper_calls)


def test_canonical_conversions_and_ints(fields):
    Fj, Ft = fields
    a, _, ints = _operands(Fj, Ft, 5)
    at = limbs_from_numpy(a)
    canon = Ft.to_canonical_limbs(at)
    np.testing.assert_array_equal(
        limbs_to_numpy(canon), np.asarray(jax.jit(Fj.to_canonical_limbs)(a)))
    np.testing.assert_array_equal(limbs_to_numpy(Ft.from_canonical_limbs(canon)),
                                  a)
    assert list(Ft.to_ints(at)) == ints
    assert [int(v) for v in Fj.to_ints(a)] == ints


def test_random_ints_draw_like_reference(fields):
    Fj, Ft = fields
    assert Ft.random_ints(9, np.random.default_rng(7)) == \
        Fj.random_ints(9, np.random.default_rng(7))
