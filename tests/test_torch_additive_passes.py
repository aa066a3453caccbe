"""K17's pass plan and pass model, and K19's block batch inversion, against
the reference.

K17 (csrc/additive_fft.cu) runs the additive FFT as the passes of
``additive_fft_plan``; ``additive_fft_passes_model`` runs the same passes
in PyTorch, a block a row.  K19 (csrc/fri_fold_additive.cu) inverts the
differences x - e by Montgomery's trick over blocks of 2,048;
``fri_fold_additive_block_model`` is that inversion in PyTorch.  Inputs
from seeded numpy generators through both packages; tolerance 0.

The reference's functions cost an XLA CPU compile per shape.  Tier 1 holds
the twins and the models to the sha256 of the reference's outputs on the
same inputs (``FFT_PINS``, ``FOLD_PINS``) and calls the reference live
once a kind; the slow tests recompute every pin.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

import libiop_tpu.algebra.subspace as jax_sub
import libiop_tpu.fields.binary as jax_binary
import libiop_tpu.protocols.fri as jax_fri
from libiop_tpu_torch.algebra import subspace
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.kernels.additive_fft import (
    MAX_OPS, additive_fft_passes_model, additive_fft_plain, additive_fft_plan,
    block_bits, inverse_plan)
from libiop_tpu_torch.kernels.fri_fold_additive import (
    BLOCK, fri_fold_additive_block_model, fri_fold_additive_plain)
from libiop_tpu_torch.protocols import fri
from torch_one_thread import one_torch_thread  # noqa: F401

#: (field, m, rows, basis) of the transforms held to the reference: every
#: m from 1 to 12, one or three rows; "std" is x^m + span(x^0 .. x^(m-1)),
#: "rand" a random basis and shift
FFT_CASES = [(name, m, 3 if m in (3, 6) else 1, "rand" if m in (6, 11)
              else "std") for name in ("gf64", "gf192") for m in range(1, 13)]

#: (block bits, low run) of the plans scaled down so that every pass kind
#: runs at these sizes: column passes (three or more a level at (3, 0) and
#: (4, 1)), tile passes, a class pass, final passes (several at (4, 1))
SMALL_PLANS = [(4, 1), (5, 2), (3, 0), (6, 3), (4, 0)]

#: sha256 of the reference's additive_fft then additive_ifft outputs (each
#: row in turn; little-endian uint32 words) per FFT_CASES entry
FFT_PINS = {
    ('gf64', 1, 1, 'std'):
        "37398c059f52e06e619cc252061bcfa54f68263bfb609bfde7162aa33c02eaf3",
    ('gf64', 2, 1, 'std'):
        "839c4affbdaa0f291b91676b2223c75bb81bdc674cc48bc0778707e0b935f95a",
    ('gf64', 3, 3, 'std'):
        "d93971a53499c7b32ba0297b7bcf64b6fbe2776eb9f352a208276473c0cfc01b",
    ('gf64', 4, 1, 'std'):
        "3c7f56939387e00d74d6a8c7b33dabc199f9362aae6845cf922832118f8fe9a4",
    ('gf64', 5, 1, 'std'):
        "17166163632eaeb6855f007e61d888aa75adf000d27c700c6829671a5a84e71f",
    ('gf64', 6, 3, 'rand'):
        "1d5ec1573780fd0cad745605454811f3da0a232fe90d9a226c94b1fe50d4b466",
    ('gf64', 7, 1, 'std'):
        "ac0868fdf4efb951501d820df729ed265ab338b01c0c07ce6b409f319256836e",
    ('gf64', 8, 1, 'std'):
        "856013d6d2f28bece58c7a4adf6c8f569806ca87e58bf890e095edf79c1da8f0",
    ('gf64', 9, 1, 'std'):
        "55609551c5685dd59ee05a772b2e7dbe9fc63e7402e7e937b2859f10054fa52f",
    ('gf64', 10, 1, 'std'):
        "47d16a0acf3475f9e36d74fe705e16450c523b83285962585abbab25c42ea83e",
    ('gf64', 11, 1, 'rand'):
        "5aeb8f7bfc7654745746c8319daaa29739a09bbe9821142b46f0a9c4129c5a6b",
    ('gf64', 12, 1, 'std'):
        "51baff78239b37f46fc623d69f24e1fc6bdecceede316babdda95d9afe39793b",
    ('gf192', 1, 1, 'std'):
        "2a25a24bb179fc3b6ae1905a18792f30dc31151d48d59e7457a262396109a73e",
    ('gf192', 2, 1, 'std'):
        "18a3adf4386f2dd6c635b1f88c772ecf4227c3458804686343665a39e26c11dc",
    ('gf192', 3, 3, 'std'):
        "f55385fa2fc294a3eb50b5dc3fa8c2a912062192e31764b900e5ad34c4266b69",
    ('gf192', 4, 1, 'std'):
        "6c17922d2cb6f3e948cd4746e5d828a6087cbdd0d5b8df39b0971dcc560467ff",
    ('gf192', 5, 1, 'std'):
        "2930a54ab9ed5ed0e018bd637010154fb7572ffa43386d99276a616d7bc6e83a",
    ('gf192', 6, 3, 'rand'):
        "f3ddf54c5d9fbe3a049d7688eece8dbd1ea3d4c7915f2815ba9610dc77c5e328",
    ('gf192', 7, 1, 'std'):
        "260853300512d82e89ad42eb471929d41d505a2568af10d9d83341883260cc14",
    ('gf192', 8, 1, 'std'):
        "579d168588adf68be76d8865c6ec8ef43438454472ab3b2c7c640b6dfe594323",
    ('gf192', 9, 1, 'std'):
        "d447fa7d8b148ab7ceb9acdcb941c75285426a0480781599f67ab406d8e3233a",
    ('gf192', 10, 1, 'std'):
        "2fdcc4323b38881730752c83b8a4ea9634adb60185f044eff8f7f18e759b8806",
    ('gf192', 11, 1, 'rand'):
        "15d64befb28e08ba4ab0c54d55121bec0554eb94b8a8181e0fc7e81e3fca4c4c",
    ('gf192', 12, 1, 'std'):
        "01689742cccfc1924bbf765e56c08a789b7861aaf0c67373af6300a48ca835e4",
}

#: (field, subspace dimension, eta, point) of the folds held to the
#: reference: several blocks (2^12 = 2 x 2,048) and one partial block
FOLD_CASES = [("gf64", 12, eta, point) for eta in (1, 2)
              for point in ("outside", "member")] + [
    ("gf192", 9, 2, point) for point in ("outside", "member")]

#: sha256 of the reference's fold_codeword_additive output per FOLD_CASES
#: entry
FOLD_PINS = {
    ('gf64', 12, 1, 'outside'):
        "26712e35fa643201d016aab496b26d07ff99531b03c1047916e5bc0ba85f55d7",
    ('gf64', 12, 1, 'member'):
        "e76eb835dc240a57fd9e8296c9ae0fc053fc5143550954922a2c2b12b278afbe",
    ('gf64', 12, 2, 'outside'):
        "e45815835dcb1340de31b6ce105bb06dbff30991c92e2bd18ba2510ca51f717c",
    ('gf64', 12, 2, 'member'):
        "8e28c403cd7fda57262d707e789b2c3d37ba9a0d42cfb0732b6c123e82bee23b",
    ('gf192', 9, 2, 'outside'):
        "8ddd4d502cf7911e2525783352de587de04b893c8bdd2b130e59472752f35a9f",
    ('gf192', 9, 2, 'member'):
        "6305f57c57bda041aa38d742dfb513304e7edb4e2e3ac6ab3199960e911bdf03",
}


def _digest(arrays):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).astype(
            "<u4").tobytes() for a in arrays)).hexdigest()


def _domain(name, m, basis):
    """(port field, reference field, port subspace, reference subspace)."""
    Ft, Fj = getattr(binary, name)(), getattr(jax_binary, name)()
    if basis == "std":
        shift, vecs = 1 << m, None
    else:
        rng = np.random.default_rng(500 + m)
        shift, vecs = Ft.random_ints(1, rng)[0], Ft.random_ints(m, rng)
    return (Ft, Fj, subspace.AffineSubspace(Ft, m, shift=shift, basis=vecs),
            jax_sub.AffineSubspace(Fj, m, shift=shift, basis=vecs))


def _fft_inputs(name, m, rows, basis):
    Ft, Fj, D, Dj = _domain(name, m, basis)
    words = np.random.default_rng(100 * m + rows).integers(
        0, 1 << 32, size=(Ft.W, rows, 1 << m), dtype=np.uint64).astype(
            np.uint32)
    return Ft, D, Dj, limbs_from_numpy(words)


def _fft_reference(D, Dj, x):
    """The reference's forward outputs of each row, then its inverse ones."""
    rows = [limbs_to_numpy(x[:, r]) for r in range(x.shape[1])]
    return ([np.asarray(jax_sub.additive_fft(jnp.asarray(r), Dj))
             for r in rows]
            + [np.asarray(jax_sub.additive_ifft(jnp.asarray(r), Dj))
               for r in rows])


def _fft_twin(Ft, D, x):
    out = []
    for inverse in (False, True):
        tw, sums = subspace.fft_tables(D, "cpu", inverse)
        y = additive_fft_plain(Ft, x, tw, sums, inverse)
        out += [limbs_to_numpy(y[:, r]) for r in range(x.shape[1])]
    return out


def test_additive_fft_plan_covers_every_step_once():
    """The forward plan's steps, pass after pass, are the reference's:
    level j's twist and radix steps b = m-2 .. j for j = 0 .. m-1, then
    the unwind levels 0 .. m-1; every step mixes only its pass's inside
    bits; one pass reverses the order, and the passes in the radix order
    come before it; the inverse plan is the same steps backwards.  Blocks
    fit shared memory; 2^16 takes at most 16 launches and 2^20 at most
    24, at every width."""
    for W in (2, 4, 6, 8):
        for m in range(1, 21):
            plans = [additive_fft_plan(m, W)] + [
                additive_fft_plan(m, W, B, c) for B, c in SMALL_PLANS
                if m > B]
            want = []
            for j in range(m):
                want += [("twist", j)] + [("radix", b)
                                          for b in range(m - 2, j - 1, -1)]
            want += [("unwind", j) for j in range(m)]
            for plan in plans:
                assert [op for p in plan for op in p.ops] == want, (W, m)
                rev = [k for k, p in enumerate(plan)
                       if p.load_rev != p.store_rev]
                assert len(rev) == 1 and not any(p.load_rev and p.store_rev
                                                 for p in plan)
                for k, p in enumerate(plan):
                    assert p.space == ("i" if k < rev[0] or p.store_rev
                                       else "o"), (W, m, k)
                    assert len(p.ops) <= MAX_OPS and p.lo >= p.low
                    for kind, a in p.ops:
                        bits = ({"radix": (a, a + 1)}.get(kind)
                                or (() if kind == "twist" else
                                    (a if p.space == "o" else m - 1 - a,)))
                        for bit in bits:
                            p.local_bit(bit)  # raises if not inside
                        assert kind == "unwind" or p.space == "i"
                inv = inverse_plan(plan)
                assert [op for p in inv for op in p.ops] == want[::-1]
            B = block_bits(m, W)
            assert all(p.bits <= B for p in plans[0])
            assert (4 * W) << B <= 232448
            if m == 16:
                assert len(plans[0]) <= 16
            if m == 20:
                assert len(plans[0]) <= 24


#: the GF(2^192) sizes of the tier-1 sweep: m = 1, m = 6 (three rows, a
#: random basis), and the edges of the default plan (2^8 the largest
#: transform one pass holds, 2^9 the first that takes several); the other
#: sizes run with -m slow (GF(2^64) runs every m in tier 1)
GF192_TIER1 = (1, 6, 8, 9)


def _check_passes_model(field, ms):
    """The pass model, forward and inverse, with the plan of each size and
    a scaled-down one, equals the twin at each m of ``ms``; the twin gives
    the reference's bytes (FFT_PINS)."""
    for k, (name, m, rows, basis) in enumerate(FFT_CASES):
        if name != field or m not in ms:
            continue
        Ft, D, _, x = _fft_inputs(name, m, rows, basis)
        twin = _fft_twin(Ft, D, x)
        assert _digest(twin) == FFT_PINS[(name, m, rows, basis)], (m, rows)
        B, c = SMALL_PLANS[k % len(SMALL_PLANS)]
        plans = [None] + ([additive_fft_plan(m, Ft.W, B, c)] if m > B
                          else [])
        for plan in plans:
            got = []
            for inverse in (False, True):
                tw, sums = subspace.fft_tables(D, "cpu", inverse)
                y = additive_fft_passes_model(Ft, x, tw, sums, inverse, plan)
                got += [limbs_to_numpy(y[:, r]) for r in range(rows)]
            assert all(np.array_equal(g, w) for g, w in zip(got, twin)), \
                (m, rows, plan)


@pytest.mark.parametrize("field,ms", [("gf64", tuple(range(1, 13))),
                                      ("gf192", GF192_TIER1)],
                         ids=["gf64", "gf192"])
def test_additive_fft_passes_model_matches_twin(field, ms):
    """The pass model equals the twin at m = 1 .. 12 over GF(2^64) and at
    the plan's edges over GF(2^192): one and three rows, shifted and
    random-basis subspaces."""
    _check_passes_model(field, ms)


@pytest.mark.slow
def test_additive_fft_passes_model_matches_twin_gf192_rest():
    """The GF(2^192) sizes of m = 1 .. 12 that tier 1 leaves out."""
    _check_passes_model("gf192", tuple(m for m in range(1, 13)
                                       if m not in GF192_TIER1))


def test_additive_fft_passes_model_matches_reference_live():
    """One transform each way against the reference live: GF(2^64), m = 3
    over a shifted subspace, blocks of 2^2 (a column, a tile, a class and
    a final pass)."""
    Ft, D, Dj, x = _fft_inputs("gf64", 3, 1, "std")
    want = _fft_reference(D, Dj, x)
    plan = additive_fft_plan(3, Ft.W, 2, 0)
    assert [len(p.ops) for p in plan] == [2, 1, 5, 1]
    for inverse, ref in zip((False, True), want):
        tw, sums = subspace.fft_tables(D, "cpu", inverse)
        got = additive_fft_passes_model(Ft, x, tw, sums, inverse, plan)
        assert np.array_equal(limbs_to_numpy(got[:, 0]), ref), inverse


def _fold_inputs(name, dim, eta, point):
    Ft, Fj, D, Dj = _domain(name, dim, "std")
    rng = np.random.default_rng(dim * 10 + eta)
    words = rng.integers(0, 1 << 32, size=(Ft.W, 1 << dim),
                         dtype=np.uint64).astype(np.uint32)
    x = (Ft.random_ints(1, rng)[0] if point == "outside"
         else D.element_by_index_int((1 << dim) - 3))
    Z = fri.localizer_vanishing(D, eta)
    args = (Ft, limbs_from_numpy(words), D.elements("cpu"),
            fri.coset_vanishing_offsets(D, eta, Z, "cpu"), x,
            Z.eval_at_point_int(x), Ft.inv_int(Z.epsilon), 1 << eta)
    return Fj, Dj, words, x, args


def test_fri_fold_block_model_matches_twin():
    """The block batch inversion equals the twin over several blocks and a
    partial one, eta 1 and 2, x outside the domain and x a domain element
    (in the last block); the twin gives the reference's bytes
    (FOLD_PINS)."""
    assert BLOCK == 2048
    for case in FOLD_CASES:
        _, _, _, _, args = _fold_inputs(*case)
        want = fri_fold_additive_plain(*args)
        assert _digest([limbs_to_numpy(want)]) == FOLD_PINS[case], case
        assert np.array_equal(limbs_to_numpy(
            fri_fold_additive_block_model(*args)), limbs_to_numpy(want)), case


def test_fri_fold_block_model_matches_reference_live():
    """One fold against the reference live: GF(2^64), 2^12 positions (two
    blocks), eta = 2, x a domain element."""
    Fj, Dj, words, x, args = _fold_inputs("gf64", 12, 2, "member")
    want = jax_fri.fold_codeword_additive(Fj, jnp.asarray(words), Dj, 2, x)
    assert np.array_equal(limbs_to_numpy(
        fri_fold_additive_block_model(*args)), np.asarray(want))


@pytest.mark.slow
@pytest.mark.parametrize("field", ["gf64", "gf192"])
def test_additive_fft_reference_pins(field):
    """Recompute FFT_PINS from the reference; the twin gives its bytes."""
    for name, m, rows, basis in FFT_CASES:
        if name != field:
            continue
        Ft, D, Dj, x = _fft_inputs(name, m, rows, basis)
        want = _fft_reference(D, Dj, x)
        assert _digest(want) == FFT_PINS[(name, m, rows, basis)], m
        assert all(np.array_equal(g, w)
                   for g, w in zip(_fft_twin(Ft, D, x), want))


@pytest.mark.slow
def test_fri_fold_reference_pins():
    """Recompute FOLD_PINS from the reference; the twin gives its bytes."""
    for case in FOLD_CASES:
        Fj, Dj, words, x, args = _fold_inputs(*case)
        want = np.asarray(jax_fri.fold_codeword_additive(
            Fj, jnp.asarray(words), Dj, case[2], x))
        assert _digest([want]) == FOLD_PINS[case], case
        assert np.array_equal(limbs_to_numpy(fri_fold_additive_plain(*args)),
                              want)
