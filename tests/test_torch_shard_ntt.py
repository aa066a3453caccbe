"""Port vs reference: the four-step ShardedNTT on in-process CPU meshes of
D = 1, 2, 4, 8 shards equals the reference's single-device NTT
(libiop_tpu.algebra.fft.fft) on the same ints, exactly; K23's four twins
equal their index formulas written in numpy; the fft hook routes what D^2
divides through ShardedNTT.  The reference's transforms cost an XLA CPU
compile each: tier 1 holds the port's outputs to the sha256 of the
reference's (``REFERENCE_PINS``) and checks one case live; the slow test
recomputes every pin."""
import hashlib

import numpy as np
import pytest
import torch

from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.algebra.fft import fft as jax_fft
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu_torch.algebra import fft as fftmod
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.fields.limbs import mul_plain
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_to_numpy
from libiop_tpu_torch.kernels import four_step
from libiop_tpu_torch.parallel.mesh import (codeword_sharding_context,
                                            make_codeword_mesh)
from libiop_tpu_torch.parallel.shard_ntt import ShardedNTT
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}
CASES = [("edwards_Fr", 8, 1), ("edwards_Fr", 8, 19), ("edwards_Fr", 9, 1),
         ("edwards_Fr", 9, 19), ("alt_bn128_Fr", 8, 19)]

#: sha256 of the reference's evaluations (little-endian uint32 limbs) of
#: each case's coefficients; the slow test recomputes them
REFERENCE_PINS = {
    ("edwards_Fr", 8, 1):
        "dc7a38a39e3871a2047f9bbec291f5d1ecd1112aa4a1cda3a03b332b3c82a86c",
    ("edwards_Fr", 8, 19):
        "54c74cb577235d06c3f4e0ec2e7dc43641a6e2af13ecaabeb12068e159ba3b1e",
    ("edwards_Fr", 9, 1):
        "b947995dec939d8ff81d59cb79b0d1c720bbf7ca70febf35f96c6ded114f195d",
    ("edwards_Fr", 9, 19):
        "fb857e10fbb79fa45e7b46af7452301fcac8f1edc2b17f584f4d2f91acb8718a",
    ("alt_bn128_Fr", 8, 19):
        "e9ba830c86604563018b8355046a7b7373df59786051e104b03cff21e4435026",
}


def _case(name, dim, shift):
    """The case's coefficients: ints below 2^61, as the reference's
    tests/test_shard_ntt.py draws them."""
    rng = np.random.default_rng(1000 * dim + shift)
    return [int(v) for v in rng.integers(0, 1 << 61, 1 << dim)]


def _digest(arr) -> str:
    return hashlib.sha256(np.asarray(arr, dtype=np.uint32).astype(
        "<u4").tobytes()).hexdigest()


def _sharded(name, dim, shift, D):
    F = FIELDS[name][1]()
    dom = MultiplicativeCoset(F, dim, shift)
    coeffs = F.from_ints(_case(name, dim, shift), "cpu")
    return ShardedNTT(dom, make_codeword_mesh(devices=["cpu"] * D))(coeffs)


def _reference(name, dim, shift) -> np.ndarray:
    F = FIELDS[name][0]()
    return np.asarray(jax_fft(F.from_ints(_case(name, dim, shift)),
                              JaxCoset(F, dim, shift=shift)), dtype=np.uint32)


@pytest.mark.parametrize(
    "name,dim,shift,D", [c + (D,) for c in CASES[:4] for D in (1, 2, 4, 8)]
    + [CASES[4] + (4,)])
def test_sharded_ntt_matches_reference(name, dim, shift, D):
    got = limbs_to_numpy(_sharded(name, dim, shift, D))
    assert _digest(got) == REFERENCE_PINS[(name, dim, shift)]


def test_sharded_ntt_matches_reference_live():
    """One case against the reference's transform computed here."""
    np.testing.assert_array_equal(
        limbs_to_numpy(_sharded("edwards_Fr", 8, 19, 8)),
        _reference("edwards_Fr", 8, 19))


@pytest.mark.slow
def test_reference_outputs_behind_the_pins():
    for case in CASES:
        assert _digest(_reference(*case)) == REFERENCE_PINS[case], case


def test_sharded_ntt_batch_and_degree():
    """(L, *batch, d) coefficients with d < N: each codeword as the local
    transform gives it."""
    F = edwards_fr()
    dom = MultiplicativeCoset(F, 6, 5)
    rng = np.random.default_rng(3)
    coeffs = F.from_ints(F.random_ints(2 * 3 * 9, rng), "cpu").reshape(
        F.L, 2, 3, 9)
    got = ShardedNTT(dom, make_codeword_mesh(devices=["cpu"] * 4))(coeffs)
    assert got.shape == (F.L, 2, 3, 64)
    assert torch.equal(got, fftmod.fft(coeffs, dom))


def test_fft_routes_under_a_mesh():
    """A forward transform that D^2 divides goes four-step, the rest
    locally; without a mesh nothing is counted."""
    F = edwards_fr()
    rng = np.random.default_rng(4)
    for k in fftmod.SHARD_ROUTES:
        fftmod.SHARD_ROUTES[k] = 0
    big, small = MultiplicativeCoset(F, 6, 7), MultiplicativeCoset(F, 3, 7)
    cb = F.from_ints(F.random_ints(64, rng), "cpu")
    cs = F.from_ints(F.random_ints(8, rng), "cpu")
    want_b, want_s = fftmod.fft(cb, big), fftmod.fft(cs, small)
    assert fftmod.SHARD_ROUTES == {"four_step": 0, "local": 0}
    with codeword_sharding_context(make_codeword_mesh(devices=["cpu"] * 4)):
        assert torch.equal(fftmod.fft(cb, big), want_b)
        assert torch.equal(fftmod.fft(cs, small), want_s)
        assert torch.equal(fftmod.ifft(want_b, big), cb)
    assert fftmod.SHARD_ROUTES == {"four_step": 1, "local": 2}


# -- K23's twins against numpy index formulas --------------------------------
def _rev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _limbs(F, n, rng, shape):
    return F.from_ints(F.random_ints(n, rng), "cpu").reshape((F.L,) + shape)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_four_step_twins_match_index_formulas(D):
    F = edwards_fr()
    rng = np.random.default_rng(D)
    R, C, B = 8, 16, 2
    N, RD, CD = R * C, R // D, C // D
    logR, logC = 3, 4
    s = D - 1
    d = N - 37
    # prologue: out[b, i, t] = x[b, j] * sp[j], j = s RD + i + R rev_C(t),
    # zero for j >= d
    x = _limbs(F, B * d, rng, (B, d))
    sp = _limbs(F, N, rng, (N,))
    xn, spn = limbs_to_numpy(x), limbs_to_numpy(sp)
    want = np.zeros((F.L, B, RD, C), np.uint32)
    tab = np.zeros((F.L, 1, RD, C), np.uint32)
    valid = np.zeros((RD, C), bool)
    for i in range(RD):
        for t in range(C):
            j = s * RD + i + R * _rev(t, logC)
            tab[:, 0, i, t] = spn[:, j]
            if j < d:
                want[:, :, i, t] = xn[:, :, j]
                valid[i, t] = True
    np.testing.assert_array_equal(
        limbs_to_numpy(four_step.prologue(F, x, s, D, R, C)), want)
    prod = limbs_to_numpy(mul_plain(F, torch.from_numpy(want.astype(
        np.int32)), torch.from_numpy(tab.astype(np.int32))))
    prod[:, :, ~valid] = 0
    np.testing.assert_array_equal(
        limbs_to_numpy(four_step.prologue(F, x, s, D, R, C, sp)), prod)
    # twiddle and pack: send[t, b, i, k] = a[b, i, t CD + k] * W[(j1 k2) % N]
    a = _limbs(F, B * RD * C, rng, (B, RD, C))
    W = _limbs(F, N, rng, (N,))
    an, Wn = limbs_to_numpy(a), limbs_to_numpy(W)
    moved = np.zeros((D, F.L, B, RD, CD), np.uint32)
    tw = np.zeros((D, F.L, 1, RD, CD), np.uint32)
    for t in range(D):
        for i in range(RD):
            for k in range(CD):
                moved[t, :, :, i, k] = an[:, :, i, t * CD + k]
                tw[t, :, 0, i, k] = Wn[:, ((s * RD + i) * (t * CD + k)) % N]
    want = np.stack([limbs_to_numpy(mul_plain(
        F, torch.from_numpy(moved[t].astype(np.int32)),
        torch.from_numpy(tw[t].astype(np.int32)))) for t in range(D)])
    np.testing.assert_array_equal(
        limbs_to_numpy(four_step.twiddle_pack(F, a, s, D, W)), want)
    # unpack: out[b, k, t] = recv[src, b, i, k], src RD + i = rev_R(t)
    recv = _limbs(F, D * B * RD * CD, rng, (D, B, RD, CD)).movedim(
        1, 0).contiguous()
    rn = limbs_to_numpy(recv)
    want = np.zeros((F.L, B, CD, R), np.uint32)
    for k in range(CD):
        for t in range(R):
            src, i = divmod(_rev(t, logR), RD)
            want[:, :, k, t] = rn[src, :, :, i, k]
    np.testing.assert_array_equal(
        limbs_to_numpy(four_step.unpack(F, recv, R)), want)
    # epilogue: out[b, k1 C + s CD + k] = g[s, b, k, k1]
    g = _limbs(F, D * B * CD * R, rng, (D, B, CD, R)).movedim(
        1, 0).contiguous()
    gn = limbs_to_numpy(g)
    want = np.zeros((F.L, B, N), np.uint32)
    for sh in range(D):
        for k in range(CD):
            for k1 in range(R):
                want[:, :, k1 * C + sh * CD + k] = gn[sh, :, :, k, k1]
    np.testing.assert_array_equal(
        limbs_to_numpy(four_step.epilogue(F, g, C)), want)
