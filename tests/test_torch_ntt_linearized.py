"""K2's pass plan and twin, and K18's blocked scan, against the reference.

K2 (csrc/ntt.cu) runs the butterfly stages m = first_m, ..., N/2 as the
passes of ``ntt_plan``; its twin is the loop of ``ntt_stage_plain`` over
the same stages.  K18 (csrc/linearized.cu) divides by a small linearized
vanishing polynomial as a blocked scan; ``linearized_divide_scan_model`` is
that scan in PyTorch (segments, carries, fix-up) for any segment length B.
Inputs from seeded numpy generators through both packages; tolerance 0.

The reference's functions cost an XLA CPU compile per shape (1.5-4 s a
call).  Tier 1 holds the twins and the scan model to the sha256 of the
reference's outputs on the same inputs (``NTT_PINS``, ``LIN_PINS``) and
calls the reference live once a kind; the slow tests recompute every pin.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

import libiop_tpu.algebra.fft as jax_fft
import libiop_tpu.algebra.generic as jax_generic
import libiop_tpu.algebra.linearized as jax_lin
import libiop_tpu.algebra.subspace as jax_sub
import libiop_tpu.fields.binary as jax_binary
from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.algebra import generic, subspace
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.kernels.linearized import (
    SCAN_MAX_H, linearized_divide_plain, linearized_divide_scan_model,
    scan_segment)
from libiop_tpu_torch.kernels.ntt import (SPAN, TILE, column_width, ntt_plan,
                                          ntt_stages_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

PRIME = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
         "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}

#: (N, rows, first_m) of the stage runs held to the reference
NTT_CASES = [(N, rows, first_m) for N in (16, 1024) for rows in (1, 3)
             for first_m in (1, 4)]

#: sha256 of the reference's _butterfly_stages outputs (forward, then
#: inverse table; little-endian uint32 limbs) per (field, N, rows, first_m)
NTT_PINS = {
    ("alt_bn128_Fr", 16, 1, 1):
        "986685abc2a26f2166e81ddfa288b02551ecca0cf2b43c249b5cb46742119c0e",
    ("alt_bn128_Fr", 16, 1, 4):
        "3a86c6099284cce41a96a6dd7dc657ccaeb0e2f3b3d099915d487fb24a9d5813",
    ("alt_bn128_Fr", 16, 3, 1):
        "f8cfb719ef7fbca802a0ab3d69dc1ce6b84e86d258240dbefc3f466972861728",
    ("alt_bn128_Fr", 16, 3, 4):
        "6982ec7fa9ed4f6fc1702a1bde2654569e06b070b67d2e958c8bf1fcf4c652ea",
    ("alt_bn128_Fr", 1024, 1, 1):
        "0483b0458abca46fbf2360dcea5be6c82cd0aeb8efa53d8d42d35e4f94813a87",
    ("alt_bn128_Fr", 1024, 1, 4):
        "637521cf297f7496da8733fb432c7ec5a992a518af1019a1b4e84896e9699759",
    ("alt_bn128_Fr", 1024, 3, 1):
        "7a0a4e30858ba711720d296802082b398e1b6bd2790870a217e49a256ab8e8f2",
    ("alt_bn128_Fr", 1024, 3, 4):
        "245ff83976af134f58a01a5d57f6c5af99da4e8714682d7dcb019ab3add536a3",
    ("edwards_Fr", 16, 1, 1):
        "d37585bd492f67f091402e77bd2260df7e4ba8ec65d2c942f6874bae85035e8c",
    ("edwards_Fr", 16, 1, 4):
        "e76e79567ad6e924850f77ce1e1ee9e89b868813a2b7cb5299ff8781a36e0eac",
    ("edwards_Fr", 16, 3, 1):
        "57acd9f322ccb5d1067a38497c8be74f85914313d61211f4919d644a64164bad",
    ("edwards_Fr", 16, 3, 4):
        "0be123e9c15895193e4ac893dbb4f3b6f97c45a3f93b84f6b631df52fe38ef72",
    ("edwards_Fr", 1024, 1, 1):
        "29c941fb34981ff9c07fedcb854090e5caa7a2ee8e6711eb7ff52814f1e363fe",
    ("edwards_Fr", 1024, 1, 4):
        "9417a7d0aeefe59ae7c357c8e8a3e8557b1b1195a4ff6b6485258a79fd61b4a5",
    ("edwards_Fr", 1024, 3, 1):
        "54e6fe27046a17ee4a71d037869012ffdeb24af67d5bf5374b3efdb5449a4c7c",
    ("edwards_Fr", 1024, 3, 4):
        "37059a3f74c313f6fc6a83da6abfcbe6a264a3a3b856bac0c3d742e84e54a87e",
}

#: (subspace dimension, d, segment lengths B) of the divisions held to the
#: reference: h = 2 over 9 coefficients; h = 16 over 149 (three segments of
#: 64 or nine of 16, the bottom one 5 long, an uneven last chunk); h = 2^10
#: over 1,724 (one segment, 700 long, an uneven last chunk of 188)
LIN_CASES = [(1, 9, (2, 4, 8)), (4, 16 + 2 * 64 + 5, (16, 64)),
             (10, 1024 + 700, (1024,))]

#: sha256 of the reference's divide_by_linearized (quotient, remainder) per
#: (field, dimension, d)
LIN_PINS = {
    ("gf64", 1, 9):
        "3a1ff3daa9ba8cd68b7ec3c410e0b6d96b125b3fd9d9230197ca28efaab66e15",
    ("gf64", 4, 149):
        "812ec3b7baeb519fee016ef4f4513d133f796371c55eae8712219ae0fef38979",
    ("gf64", 10, 1724):
        "76ad575bf0439b06ac4343a4c3a66a08b4f3b93327070ae54f48427bca40ef68",
    ("gf192", 1, 9):
        "51ccd3da60d3bbe4e599dff4fd3ac77feeac7924f461f93eb6bd3b57fe1eb3d1",
    ("gf192", 4, 149):
        "a471a389c293f70bd524aedad45ccf9413c662091914627f9222107bb9eaad1b",
    ("gf192", 10, 1724):
        "283df843338f5142a9311255929b22332f807198bd036a084c56d82cd4de1c92",
}


def _digest(arrays):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).astype(
            "<u4").tobytes() for a in arrays)).hexdigest()


def _ntt_inputs(Ft, N, rows):
    """(x (L, rows, N), forward table, inverse table) on the CPU."""
    x = Ft.from_ints(Ft.random_ints(rows * N, np.random.default_rng(
        10 * N + rows)), "cpu").reshape(Ft.L, rows, N)
    dom = MultiplicativeCoset(Ft, N.bit_length() - 1, 19)
    return x, dom.generator_powers("cpu"), dom.inverse_generator_powers("cpu")


def _ntt_reference(Fj, x, W, Winv, N, first_m):
    dom = JaxCoset(Fj, N.bit_length() - 1, 19)
    xj = jnp.asarray(limbs_to_numpy(x))
    assert np.array_equal(np.asarray(dom.generator_powers()),
                          limbs_to_numpy(W))
    assert np.array_equal(np.asarray(dom.inverse_generator_powers()),
                          limbs_to_numpy(Winv))
    return [np.asarray(jax_fft._butterfly_stages(Fj, xj, w, N, first_m))
            for w in (dom.generator_powers(), dom.inverse_generator_powers())]


def _lin_inputs(name, dim, d):
    """(port field, reference field, f (W, d), port Z's terms below x^h, h,
    port subspace, reference subspace)."""
    Ft, Fj = getattr(binary, name)(), getattr(jax_binary, name)()
    shift = 1 << (dim + 3)
    H = subspace.AffineSubspace(Ft, dim, shift=shift)
    Hj = jax_sub.AffineSubspace(Fj, dim, shift=shift)
    words = np.random.default_rng(1000 + d).integers(
        0, 1 << 32, size=(Ft.W, d), dtype=np.uint64).astype(np.uint32)
    terms = [(g, c) for g, c in generic.linearized_vanishing(
        H).coeffs_dense_positions() if g < H.order]
    return Ft, Fj, limbs_from_numpy(words), terms, H.order, Hj


def test_ntt_plan_covers_every_stage_once():
    """Every stage m = first_m, ..., N/2 in one pass, in order: a tile pass
    over 2m <= T, then a column pass from T; N <= T is one pass; a column
    pass's block fits SPAN positions."""
    T = TILE
    for log_n in range(1, 23):
        N = 1 << log_n
        assert ntt_plan(N, N) == []
        for first_m in (1 << s for s in range(log_n)):
            plan = ntt_plan(N, first_m)
            stages = []
            for kind, lo, hi in plan:
                if kind == "tile":
                    assert 2 * hi == min(T, N)
                else:
                    assert kind == "column" and lo >= T and hi == N // 2
                    C = column_width(N, T)
                    assert T % C == 0 and (N // T) * C <= SPAN
                m = lo
                while m <= hi:
                    stages.append(m)
                    m *= 2
            assert stages == [first_m << i
                              for i in range(log_n - first_m.bit_length() + 1)]
            assert len(plan) <= (1 if N <= T else 2)
            assert [k for k, _, _ in plan] == sorted(
                k for k, _, _ in plan)[::-1]  # tile before column


@pytest.mark.parametrize("field", sorted(PRIME))
def test_ntt_stages_plain_matches_reference(field):
    """The twin's stages over N = 16 and 1024, rows 1 and 3, from stage 1
    and 4, forward and inverse tables: the reference's bytes."""
    Ft = PRIME[field][1]()
    for N, rows, first_m in NTT_CASES:
        x, W, Winv = _ntt_inputs(Ft, N, rows)
        got = [limbs_to_numpy(ntt_stages_plain(Ft, x, w, first_m))
               for w in (W, Winv)]
        assert _digest(got) == NTT_PINS[(field, N, rows, first_m)], \
            (N, rows, first_m)


def test_ntt_stages_plain_matches_reference_live():
    """One run against the reference live: edwards_Fr, N = 16, 3 rows,
    the last stage (one XLA compile)."""
    Fj, Ft = jax_edwards_fr(), edwards_fr()
    x, W, Winv = _ntt_inputs(Ft, 16, 3)
    want = _ntt_reference(Fj, x, W, Winv, 16, 8)
    for w, ref in zip((W, Winv), want):
        assert np.array_equal(limbs_to_numpy(ntt_stages_plain(Ft, x, w, 8)),
                              ref)


@pytest.mark.slow
@pytest.mark.parametrize("field", sorted(PRIME))
def test_ntt_reference_pins(field):
    """Recompute NTT_PINS from the reference; the twin gives its bytes."""
    Fj, Ft = PRIME[field][0](), PRIME[field][1]()
    for N, rows, first_m in NTT_CASES:
        x, W, Winv = _ntt_inputs(Ft, N, rows)
        want = _ntt_reference(Fj, x, W, Winv, N, first_m)
        assert _digest(want) == NTT_PINS[(field, N, rows, first_m)]
        assert all(np.array_equal(limbs_to_numpy(
            ntt_stages_plain(Ft, x, w, first_m)), ref)
            for w, ref in zip((W, Winv), want))


@pytest.mark.parametrize("field", ["gf64", "gf192"])
def test_linearized_scan_model_matches_twin(field):
    """The blocked scan at every segment length of LIN_CASES and at
    scan_segment's: the twin's quotient and remainder, which are the
    reference's bytes."""
    for dim, d, segments in LIN_CASES:
        Ft, _, f, terms, h, _ = _lin_inputs(field, dim, d)
        want = linearized_divide_plain(Ft, f, terms, h)
        assert _digest([limbs_to_numpy(t) for t in want]) == \
            LIN_PINS[(field, dim, d)], (dim, d)
        plan = scan_segment(d, h)
        assert plan == 0 if h > SCAN_MAX_H else plan >= h
        for B in set(segments) | ({plan} - {0}):
            got = linearized_divide_scan_model(Ft, f, terms, h, B)
            assert all(np.array_equal(limbs_to_numpy(g), limbs_to_numpy(w))
                       for g, w in zip(got, want)), (dim, d, B)


def test_linearized_scan_model_matches_reference_live():
    """One division against the reference live: GF(2^64), h = 16 over 35
    coefficients in segments of 16 (the bottom one 3 long)."""
    Ft, Fj, f, terms, h, Hj = _lin_inputs("gf64", 4, 35)
    want = jax_lin.divide_by_linearized(
        Fj, jnp.asarray(limbs_to_numpy(f)),
        jax_generic.linearized_vanishing(Hj))
    got = linearized_divide_scan_model(Ft, f, terms, h, 16)
    assert all(np.array_equal(limbs_to_numpy(g), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.slow
@pytest.mark.parametrize("field", ["gf64", "gf192"])
def test_linearized_reference_pins(field):
    """Recompute LIN_PINS from the reference; the scan model gives its
    bytes."""
    for dim, d, segments in LIN_CASES:
        Ft, Fj, f, terms, h, Hj = _lin_inputs(field, dim, d)
        want = [np.asarray(w) for w in jax_lin.divide_by_linearized(
            Fj, jnp.asarray(limbs_to_numpy(f)),
            jax_generic.linearized_vanishing(Hj))]
        assert _digest(want) == LIN_PINS[(field, dim, d)]
        got = linearized_divide_scan_model(Ft, f, terms, h, segments[-1])
        assert all(np.array_equal(limbs_to_numpy(g), w)
                   for g, w in zip(got, want))
