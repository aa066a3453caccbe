"""Port vs reference for the binary-field modules and the twins of their
kernels: GF(2^k) product, square and inverse (K16), the additive FFT and
IFFT (K17) with their stage tables, division and multiplication by a
linearized vanishing polynomial (K18) and the additive FRI fold (K19).
Inputs from seeded numpy generators through both packages; tolerance 0.

The reference's device functions cost an XLA CPU compile each.  Tier 1
holds the port's outputs to the sha256 of the reference's outputs on the
same inputs (``PINS``) and checks the host-int parts (field ints, FFT stage
tables) against the reference live; the slow test recomputes every
reference output, compares it with the port's and checks the pin."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

import libiop_tpu.algebra.generic as jax_generic
import libiop_tpu.algebra.linearized as jax_lin
import libiop_tpu.algebra.subspace as jax_sub
import libiop_tpu.fields.binary as jax_binary
import libiop_tpu.protocols.fri as jax_fri
from libiop_tpu_torch.algebra import generic, subspace
from libiop_tpu_torch.algebra.linearized import divide_by_linearized
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.protocols import fri
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("gf64", "gf128", "gf192", "gf256")

#: (kind, field): "field" mul, square and inv of 64 pairs; "fft" forward
#: (full and half degree) and inverse transforms over a shifted standard
#: subspace of 2^5 and a random-basis subspace of 2^4; "linearized"
#: quotient, remainder and product for Z of 2^3 and 2^2 (a deep division);
#: "fold" eta = 1 and 2 over a shifted 2^5, at a random point and at a
#: domain element
CASES = ([("field", f) for f in FIELDS]
         + [(kind, f) for kind in ("fft", "linearized", "fold")
            for f in ("gf64", "gf192")])

#: sha256 of the reference's outputs (little-endian uint32 words) per case
PINS = {
    ("field", "gf64"):
        "81b9ad8d163a5ad6b7d839ec45af8445c7b2c466ccbb9f5e9f29412b16c77cf1",
    ("field", "gf128"):
        "a3d895a72384a936870b55c1daa64398f1ff8497c9efca97f0344ee53bb26347",
    ("field", "gf192"):
        "76813127fc8519e08b9da0aeadb73231c1b6a4ca3cfcffe315dd8ae0d6799e1d",
    ("field", "gf256"):
        "14bbae36c233b8c8d94046143f71398a5099e7bea11147238b38373a51e883d0",
    ("fft", "gf64"):
        "9fdf8a7457dd431adf46129e6ccb06c60dbee9497d2080f698363cf67495d94b",
    ("fft", "gf192"):
        "fb106164a9953861d15129c117234a613ab4edfe8dfa5a5efefa5914aefd04fb",
    ("linearized", "gf64"):
        "0e33e259fb7241ce643116c2b78b5075a6441ca82fbd551526fd927b37bc8e30",
    ("linearized", "gf192"):
        "aa54beeae6cae7f8350ae7c5d8f0091e4069e3c97a94daf44f0c26a4f6399f18",
    ("fold", "gf64"):
        "b870df634656d0cf125c2ff6ee894c6609891d3abbc1c0816c30519ddaf73333",
    ("fold", "gf192"):
        "38202c142053d4f77a0b1872b7ae730520de53bfbe64ca326866405ceaafd835",
}


def _fields(name):
    return getattr(jax_binary, name)(), getattr(binary, name)()


def _digest(arrays):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).astype(
            "<u4").tobytes() for a in arrays)).hexdigest()


def _domains(Fj, Ft, rng):
    """(reference, port) pairs: a shifted standard subspace and a random
    basis with a random shift."""
    basis = Fj.random_ints(4, rng)
    shift = Fj.random_ints(1, rng)[0]
    return [(jax_sub.AffineSubspace(Fj, 5, shift=1 << 5),
             subspace.AffineSubspace(Ft, 5, shift=1 << 5)),
            (jax_sub.AffineSubspace(Fj, 4, shift=shift, basis=basis),
             subspace.AffineSubspace(Ft, 4, shift=shift, basis=basis))]


def _case_inputs(kind, name):
    Fj, Ft = _fields(name)
    kinds = ("field", "fft", "linearized", "fold")
    rng = np.random.default_rng(10 * FIELDS.index(name) + kinds.index(kind))
    return Fj, Ft, rng


def _port_outputs(kind, name):
    """The port's outputs (numpy uint32 arrays) of a case."""
    Fj, Ft, rng = _case_inputs(kind, name)
    out = []
    if kind == "field":
        a = Ft.from_ints(Ft.random_ints(64, rng), "cpu")
        b = Ft.from_ints(Ft.random_ints(64, rng), "cpu")
        a[:, 0] = 0
        out = [Ft.mul(a, b), Ft.square(a), Ft.inv(a)]
    elif kind == "fft":
        for _, dt in _domains(Fj, Ft, rng):
            n = dt.order
            c = Ft.from_ints(Ft.random_ints(n, rng), "cpu")
            e = Ft.from_ints(Ft.random_ints(n, rng), "cpu")
            out += [generic.fft_any(c, dt),
                    generic.fft_any(c[:, :n // 2].contiguous(), dt),
                    generic.ifft_any(e, dt)]
    elif kind == "linearized":
        for dim, d in ((3, 20), (2, 40)):
            shift = Ft.random_ints(1, rng)[0]
            H = subspace.AffineSubspace(Ft, dim, shift=shift)
            c = Ft.from_ints(Ft.random_ints(d, rng), "cpu")
            q, r = divide_by_linearized(Ft, c, generic.linearized_vanishing(H))
            out += [q, r, generic.mul_by_vanishing_any(c, H)]
    else:
        dt = subspace.AffineSubspace(Ft, 5, shift=1 << 5)
        e = Ft.from_ints(Ft.random_ints(dt.order, rng), "cpu")
        x = Ft.random_ints(1, rng)[0]
        for eta in (1, 2):
            for point in (x, dt.element_by_index_int(13)):
                out.append(fri.fold_codeword_additive(Ft, e, dt, eta, point))
    return [limbs_to_numpy(t) for t in out]


def _reference_outputs(kind, name):
    """The reference's outputs of a case, on the same draws."""
    Fj, Ft, rng = _case_inputs(kind, name)
    out = []
    if kind == "field":
        a = Fj.from_ints_np(Fj.random_ints(64, rng))
        b = Fj.from_ints_np(Fj.random_ints(64, rng))
        a[:, 0] = 0
        a, b = jnp.asarray(a), jnp.asarray(b)
        out = [Fj.mul(a, b), Fj.square(a), Fj.inv(a)]
    elif kind == "fft":
        for dj, _ in _domains(Fj, Ft, rng):
            n = dj.order
            c = jnp.asarray(Fj.from_ints_np(Fj.random_ints(n, rng)))
            e = jnp.asarray(Fj.from_ints_np(Fj.random_ints(n, rng)))
            out += [jax_generic.fft_any(c, dj),
                    jax_generic.fft_any(c[:, :n // 2], dj),
                    jax_generic.ifft_any(e, dj)]
    elif kind == "linearized":
        for dim, d in ((3, 20), (2, 40)):
            shift = Fj.random_ints(1, rng)[0]
            H = jax_sub.AffineSubspace(Fj, dim, shift=shift)
            c = jnp.asarray(Fj.from_ints_np(Fj.random_ints(d, rng)))
            q, r = jax_lin.divide_by_linearized(
                Fj, c, jax_generic.linearized_vanishing(H))
            out += [q, r, jax_generic.mul_by_vanishing_any(c, H)]
    else:
        dj = jax_sub.AffineSubspace(Fj, 5, shift=1 << 5)
        e = jnp.asarray(Fj.from_ints_np(Fj.random_ints(dj.order, rng)))
        x = Fj.random_ints(1, rng)[0]
        for eta in (1, 2):
            for point in (x, dj.element_by_index_int(13)):
                out.append(jax_fri.fold_codeword_additive(Fj, e, dj, eta,
                                                          point))
    return [np.asarray(t, dtype=np.uint32) for t in out]


@pytest.mark.parametrize("kind,name", CASES)
def test_binary_modules_match_reference_pins(kind, name):
    got = _port_outputs(kind, name)
    assert _digest(got) == PINS[(kind, name)], (kind, name)
    Fj, Ft, rng = _case_inputs(kind, name)
    if kind == "field":
        # the host-int methods against the reference's, live
        xs = Fj.random_ints(16, np.random.default_rng(5))
        assert Ft.random_ints(16, np.random.default_rng(5)) == xs
        assert (Ft.from_ints_np(xs) == Fj.from_ints_np(xs)).all()
        for a, b in zip(xs, xs[1:] + xs[:1]):
            assert Ft.mul_ints(a, b) == Fj.mul_ints(a, b)
        for a in xs[:3]:
            assert Ft.inv_int(a) == Fj.inv_int(a)
        assert list(Ft.to_ints(limbs_from_numpy(Fj.from_ints_np(xs)))) == xs
    if kind == "fft":
        # the device-built stage tables equal the reference's host tables
        for dj, dt in _domains(Fj, Ft, rng):
            tw, unwind = jax_sub._fft_stage_tables(dj)
            twt, sums = subspace.fft_tables(dt, "cpu", inverse=False)
            itw, _ = subspace.fft_tables(dt, "cpu", inverse=True)
            flat = [v for level in tw for v in level]
            assert list(Ft.to_ints(twt)) == flat
            # the inverse powers: the reference inverts each power
            assert all(Fj.mul_ints(v, w) == 1 for v, w in zip(
                flat, Ft.to_ints(itw)))
            assert list(Ft.to_ints(sums)) == [v for u in unwind for v in u]


@pytest.mark.slow
def test_reference_outputs_behind_the_pins():
    for kind, name in CASES:
        want = _reference_outputs(kind, name)
        got = _port_outputs(kind, name)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert _digest(want) == PINS[(kind, name)], (kind, name)
