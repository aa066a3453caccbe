"""Time K2 (the NTT's butterfly stages) and K18's deep division of one tree
of the port on the card, so that two trees (a parent and a change) can be
compared on one card in one run:

    git archive <parent> libiop_tpu_torch | tar -x -C checkout/parent
    for t in checkout/parent . . checkout/parent; do
        python3 tools/ntt_divide_probe.py $t; done

The tree's libiop_tpu_torch is imported (its two kernel sources built
with -Xptxas=-v); nothing else of the tree is read.  K2 runs through
algebra.fft._butterfly_stages, in place (the entry every tree has): one
row of 2^19 from stage 1 (chip_smoke.py phase 3's transform), one row of
2^20 from stage 4 (the zk codeword's largest transform) and three rows of
2^20, over edwards_Fr and alt_bn128_Fr.  K18 divides 65,648 coefficients
over GF(2^192) and GF(2^64) by the Z of a 16-point subspace (the witness's
division by the input domain's Z, 8,204 chunks of 8).  On a tree whose
kernels take them, K2 also runs with tiles of 2^11 and K18 with segments
of 256 to 2,048 (its scan_segment replaced).  K2's results are held to
the tree's plain twin first; K18's to each other, and their sha256 is
printed (the plain twin takes ~30 s a division on the card: chip_smoke.py
and the GPU tests hold K18 to it), so two trees agree when their digests
do.
Each entry: ``dev`` device-only ms a call (tools/device_timing.py
device_ms), ``call`` one call between two events, ``launches`` a call.
Prints one ``RESULT`` JSON line.
"""
import hashlib
import json
import os
import sys

TREE = os.path.abspath(sys.argv[1])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE, REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libiop_tpu_torch.algebra import fft, subspace  # noqa: E402
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset  # noqa: E402
from libiop_tpu_torch.algebra.generic import linearized_vanishing  # noqa: E402
from libiop_tpu_torch.fields.binary import gf64, gf192  # noqa: E402
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr  # noqa: E402
from libiop_tpu_torch.kernels import linearized as k18  # noqa: E402
from libiop_tpu_torch.kernels import ntt as k2  # noqa: E402
from tools.probe_common import build_sources, launch_times  # noqa: E402


def stages_plain(F, x, W, first_m):
    m = first_m
    while m < x.shape[-1]:
        x = k2.ntt_stage_plain(F, x, W, m)
        m *= 2
    return x


def probe_ntt(res, rng, dev):
    tiles = [None] + ([1 << 11] if hasattr(k2, "TILE") else [])
    for F in (edwards_fr(), alt_bn128_fr()):
        for rows, log_n, first_m in ((1, 19, 1), (1, 20, 4), (3, 20, 1)):
            N = 1 << log_n
            W = MultiplicativeCoset(F, log_n, 19).generator_powers(dev)
            x0 = F.from_ints(F.random_ints(rows * N, rng), dev).reshape(
                F.L, rows, N)
            want = stages_plain(F, x0, W, first_m)
            for tile in tiles:
                if tile:
                    saved, k2.TILE = k2.TILE, tile
                x = x0.clone()
                assert torch.equal(
                    fft._butterfly_stages(F, x, W, N, first_m), want)
                res[f"k2_{F.L}_{rows}x2^{log_n}_from{first_m}"
                    + (f"_tile{tile}" if tile else "")] = launch_times(
                    lambda: fft._butterfly_stages(F, x, W, N, first_m),
                    "ntt_stage")
                if tile:
                    k2.TILE = saved
            del want


def probe_divide(res, rng, dev):
    d = 65648
    planned = getattr(k18, "scan_segment", None)
    segments = [None] + ([256, 512, 1024, 2048] if planned else [])
    for F in (gf192(), gf64()):
        H = subspace.AffineSubspace(F, 4, shift=1 << 7)
        terms = [(g, c) for g, c in linearized_vanishing(
            H).coeffs_dense_positions() if g < H.order]
        f = F.from_ints(F.random_ints(d, rng), dev).reshape(F.W, d)
        want = None
        for B in segments:
            if B:
                k18.scan_segment = lambda d, h, B=B: B
            got = torch.cat(k18.linearized_divide(F, f, terms, H.order),
                            dim=1)
            if want is None:
                want = got
                res[f"k18_{F.name}_sha256"] = hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest()
            assert torch.equal(got, want)
            key = f"k18_{F.name}_d{d}_h16" + (f"_B{B}" if B else "")
            res[key] = launch_times(
                lambda: k18.linearized_divide(F, f, terms, H.order),
                "linearized")
            if B:
                k18.scan_segment = planned


def main():
    build_sources(("ntt", "linearized"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    res = {"tree": TREE, "device": torch.cuda.get_device_name(0)}
    probe_ntt(res, rng, dev)
    probe_divide(res, rng, dev)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
