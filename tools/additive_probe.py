"""Time K17 (the additive FFT) and K19 (the additive FRI fold) of one tree
of the port on the card, so that two trees (a parent and a change) can be
compared on one card in one run:

    git archive <parent> libiop_tpu_torch | tar -x -C checkout/parent
    for t in checkout/parent . . checkout/parent; do
        python3 tools/additive_probe.py $t; done

The tree's libiop_tpu_torch is imported (its two kernel sources built
with -Xptxas=-v); nothing else of the tree is read.  K17 runs through
kernels.additive_fft.additive_fft with the tables of
algebra.subspace.fft_tables over x^m + span(x^0 .. x^(m-1)): the GF(2^192)
paths' most frequent calls, an IFFT of 2^16 and the FFT of 2^20
(chip_smoke.py phases 3 and 13), an FFT of 2^16, and the GF(2^64) Ligero
path's batched row transforms, 32 rows of 2^12 forward and inverse.  K19
folds 2^20 positions at eta = 1 over GF(2^192) and GF(2^64) (phase 3's
row) at a point outside the domain and at a domain element.  The small
shapes are held to the tree's plain twin; every output's sha256 is
printed, so two trees agree when their digests do.  ``--sweep`` (a tree
with additive_fft_plan) also times K17's three transforms with other
block sizes and low runs than the plan's (``sweep`` in the result: ms by
shape, block bits, low run and launches), each output equal to the
plan's.
Each entry: ``dev`` device-only ms a call (tools/device_timing.py
device_ms), ``call`` one call between two events, ``launches`` a call.
Prints one ``RESULT`` JSON line.
"""
import hashlib
import json
import os
import sys

TREE = os.path.abspath(sys.argv[1])
SWEEP = "--sweep" in sys.argv[2:]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE, REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libiop_tpu_torch.algebra import subspace  # noqa: E402
from libiop_tpu_torch.fields.binary import gf64, gf192  # noqa: E402
from libiop_tpu_torch.kernels import additive_fft as k17  # noqa: E402
from libiop_tpu_torch.kernels import fri_fold_additive as k19  # noqa: E402
from libiop_tpu_torch.protocols import fri  # noqa: E402
from tools.device_timing import device_ms  # noqa: E402
from tools.probe_common import build_sources, launch_times  # noqa: E402

STEMS = ("additive_fft", "fri_fold_additive")


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def words(F, n, rng, dev):
    return torch.from_numpy(rng.integers(0, 1 << 32, size=(F.W, n),
                                         dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def probe_fft(res, rng, dev):
    for F, rows, m, inverse, check in (
            (gf192(), 1, 16, True, True), (gf192(), 1, 16, False, True),
            (gf192(), 1, 20, False, False), (gf64(), 32, 12, True, True),
            (gf64(), 32, 12, False, True)):
        D = subspace.AffineSubspace(F, m, shift=1 << m)
        x = words(F, rows << m, rng, dev).reshape(F.W, rows, 1 << m)
        if rows == 1:
            x = x[:, 0].contiguous()
        tw, sums = subspace.fft_tables(D, dev, inverse)
        got = k17.additive_fft(F, x, tw, sums, inverse)
        if check:
            assert torch.equal(got, k17.additive_fft_plain(F, x, tw, sums,
                                                           inverse))
        key = (f"k17_{F.name}_{rows}x2^{m}_{'ifft' if inverse else 'fft'}")
        res[key] = launch_times(
            lambda: k17.additive_fft(F, x, tw, sums, inverse), "additive_fft")
        res[key]["sha256"] = digest(got)


def probe_fold(res, rng, dev):
    m = 20
    for F in (gf192(), gf64()):
        D = subspace.AffineSubspace(F, m, shift=1 << m)
        v = words(F, 1 << m, rng, dev)
        Z = fri.localizer_vanishing(D, 1)
        offs = fri.coset_vanishing_offsets(D, 1, Z, dev)
        elems = D.elements(dev)
        for tag, pt in (("out", F.random_ints(1, rng)[0]),
                        ("member", D.element_by_index_int((1 << m) // 3))):
            args = (F, v, elems, offs, pt, Z.eval_at_point_int(pt),
                    F.inv_int(Z.epsilon), 2)
            key = f"k19_{F.name}_2^{m}_eta1_{tag}"
            res[key] = launch_times(lambda: k19.fri_fold_additive(*args),
                                    "fri_fold_additive")
            res[key]["sha256"] = digest(k19.fri_fold_additive(*args))


#: (field, rows, m, inverse, (block bits, low run) variants) of the sweep
SWEEP_CASES = (
    (gf192, 1, 16, True, [(9, 0), (8, 0), (10, 0), (10, 1), (11, 2)]),
    (gf192, 1, 20, False, [(13, 3), (12, 3), (12, 2), (13, 2), (12, 0)]),
    (gf64, 32, 12, True, [(8, 0), (9, 0), (10, 0), (11, 0), (10, 2)]))


def probe_sweep(res, rng, dev):
    plan = k17.additive_fft_plan
    res["sweep"] = {}
    for Fn, rows, m, inverse, variants in SWEEP_CASES:
        F = Fn()
        D = subspace.AffineSubspace(F, m, shift=1 << m)
        x = words(F, rows << m, rng, dev).reshape(F.W, rows, 1 << m)
        tw, sums = subspace.fft_tables(D, dev, inverse)
        want = k17.additive_fft(F, x, tw, sums, inverse)
        try:
            for B, c in variants:
                k17.additive_fft_plan = (
                    lambda m_, W_, block=None, coalesce=None, B=B, c=c:
                    plan(m_, W_, B, c))
                k17._encoded.cache_clear()
                assert torch.equal(k17.additive_fft(F, x, tw, sums, inverse),
                                   want)
                ms, _ = device_ms(
                    lambda: k17.additive_fft(F, x, tw, sums, inverse))
                res["sweep"][f"{F.name}_{rows}x2^{m}_B{B}_c{c}_launches"
                             f"{len(plan(m, F.W, B, c))}"] = ms
        finally:
            k17.additive_fft_plan = plan
            k17._encoded.cache_clear()


def main():
    build_sources(STEMS)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    res = {"tree": TREE, "device": torch.cuda.get_device_name(0)}
    probe_fft(res, rng, dev)
    probe_fold(res, rng, dev)
    if SWEEP:
        probe_sweep(res, rng, dev)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
