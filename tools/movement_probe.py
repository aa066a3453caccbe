"""Time K13 (column placement) and K23's unpack and epilogue of one tree of
the port on the card, beside the PyTorch calls that compute the same
functions, so that two trees (a parent and a change) can be compared on
one card in one run:

    git archive <parent> libiop_tpu_torch | tar -x -C checkout/parent
    for t in checkout/parent . . checkout/parent; do
        python3 tools/movement_probe.py $t; done

The tree's libiop_tpu_torch is imported (its two kernel sources built
with -Xptxas=-v); nothing else of the tree is read.  Shapes: K13 at
2^16 values into 2^16 columns of 12 and 16 limbs through three int32 maps
(the identity, which the Aurora path's recorded call is, lincheck's
reindex of a 2^4 input subgroup, and a random permutation) and the random
one as int64; K23 at the sharded Aurora prove's largest call (N = 2^18 on
4 shards, R = C = 512).  Each entry: ``dev`` device-only ms a call
(tools/device_timing.py device_ms), ``cupti`` the same from CUPTI,
``call`` one call between two events, ``host_bound`` 200 calls back to
back with no spin (the host's dispatch rate where it is the slower side);
``route_host_ms`` is generic.place_columns on a read-only 2^16 positions
array, host clock.  Prints one ``RESULT`` JSON line.
"""
import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[1])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TREE, REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libiop_tpu_torch.algebra import generic  # noqa: E402
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr  # noqa: E402
from libiop_tpu_torch.kernels import LAUNCHES  # noqa: E402
from libiop_tpu_torch.kernels import four_step as k23  # noqa: E402
from libiop_tpu_torch.kernels import place_columns as k13  # noqa: E402
from tools.device_timing import cupti_ms, device_ms, time_ms  # noqa: E402
from tools.probe_common import build_sources  # noqa: E402


def host_bound_ms(fn, n=200):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def times(fn):
    return {"dev": device_ms(fn)[0], "cupti": cupti_ms(fn, 200),
            "call": time_ms(fn), "host_bound": host_bound_ms(fn)}


def reindex(dim, sub, i):
    """MultiplicativeCoset.reindex_by_subgroup of a 2^dim coset."""
    order_s, order_g = 1 << sub, 1 << (dim - sub)
    if i < order_s:
        return i * order_g
    j = i - order_s
    return j + j // (order_g - 1) + 1


def main():
    build_sources(("place_columns", "four_step"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n = 1 << 16
    v2v = np.array([reindex(16, 4, i) for i in range(n)])
    inv_v2v = np.empty(n, np.int64)
    inv_v2v[v2v] = np.arange(n)
    maps = {"identity": np.arange(n), "reindex": inv_v2v,
            "random": rng.permutation(n)}
    res = {"tree": TREE}
    for F in (edwards_fr(), alt_bn128_fr()):
        vals = F.from_ints(F.random_ints(n, rng), dev)
        padded = torch.cat([vals, vals.new_zeros((F.L, 1))], dim=1)
        cases = [(name, torch.int32) for name in maps] + \
            [("random", torch.int64)]
        for name, dtype in cases:
            inv = torch.from_numpy(maps[name]).to(dtype).to(dev)
            before = LAUNCHES["place_columns"]
            got = k13.place_columns(vals, inv)
            assert LAUNCHES["place_columns"] == before + 1
            assert torch.equal(got, k13.place_columns_plain(vals, inv))
            tag = f"{F.L}_{name}_{str(dtype)[-5:]}"
            res[f"k13_{tag}"] = times(lambda: k13.place_columns(vals, inv))
            res[f"index_select_{tag}"] = times(
                lambda: torch.index_select(padded, 1, inv))
        pos = maps["random"].copy()
        pos.setflags(write=False)
        generic.place_columns(vals, pos, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            generic.place_columns(vals, pos, n)
        torch.cuda.synchronize()
        res[f"route_host_ms_{F.L}"] = (time.perf_counter() - t0) * 1e3 / 50

        D, R, C, B = 4, 512, 512, 1
        RD, CD = R // D, C // D
        recv = F.from_ints(F.random_ints(D * B * RD * CD, rng), dev).reshape(
            F.L, D, B, RD, CD).movedim(1, 0).contiguous()
        g = F.from_ints(F.random_ints(D * B * CD * R, rng), dev).reshape(
            F.L, D, B, CD, R).movedim(1, 0).contiguous()
        assert torch.equal(k23.unpack(F, recv, R), k23.unpack_plain(recv, R))
        assert torch.equal(k23.epilogue(F, g, C), k23.epilogue_plain(g, C))
        flat = k23.unpack_plain(torch.arange(
            recv.numel(), device=dev, dtype=torch.int64).reshape(recv.shape),
            R).reshape(-1)
        res[f"unpack_{F.L}"] = times(lambda: k23.unpack(F, recv, R))
        res[f"take_{F.L}"] = times(lambda: torch.take(recv, flat))
        res[f"epilogue_{F.L}"] = times(lambda: k23.epilogue(F, g, C))
        res[f"permute_{F.L}"] = times(
            lambda: g.permute(1, 2, 4, 0, 3).contiguous())
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
