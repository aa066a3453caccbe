"""Kernel K8's tapes against the eager definitions, on the CPU (no JAX).

For each of the port's virtual oracles, the runtime's fused evaluation
(postorder walk -> tape -> the plain twin interpreting it) equals the
oracle's eager ``evaluated_contents`` on random constituents, limb for limb.
The golden pins (tests/test_torch_aurora.py, tests/test_torch_zk_aurora.py)
hold the whole fused path to the JAX package."""
import numpy as np
import pytest
import torch

from libiop_tpu_torch.algebra.generic import (element_outside_of_subset,
                                              make_domain)
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.iop.runtime import IOPProtocol
from libiop_tpu_torch.kernels.fused_dag import MAX_REGS, TapeRecorder
from libiop_tpu_torch.protocols.common import RandomLinearCombinationOracle
from libiop_tpu_torch.protocols.ldt_reducer import CombinedLDTOracle
from libiop_tpu_torch.protocols.lincheck import MultiLincheckVirtualOracle
from libiop_tpu_torch.protocols.r1cs_rs_iop import FzOracle, RowcheckOracle
from libiop_tpu_torch.protocols.sumcheck import SumcheckGOracle
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from torch_one_thread import one_torch_thread  # noqa: F401

F = edwards_fr()
H = make_domain(F, 4)                      # constraint = variable = summation
L = make_domain(F, 6, shift=element_outside_of_subset(F, 6))


def _ints(n, rng):
    return F.random_ints(n, rng)


def _oracle(kind, rng):
    """(oracle with its challenge set, number of constituents)."""
    if kind == "rlc":
        o = RandomLinearCombinationOracle(F, 3)
        o.set_coefficients(_ints(3, rng))
        return o, 3
    if kind == "sumcheck_g":
        o = SumcheckGOracle(F, H, L)
        o.set_claimed_sum(_ints(1, rng)[0])
        return o, 2
    if kind == "fz":
        o = FzOracle(F, H.get_subset_of_order(4), L)
        o.set_primary_input(_ints(3, rng))
        return o, 1
    if kind == "rowcheck":
        return RowcheckOracle(F, L, H), 3
    if kind == "lincheck":
        cs = generate_r1cs_example(F, 16, 3, 15, np.random.default_rng(1))[0]
        o = MultiLincheckVirtualOracle(F, L, H, H, H, 2, list(cs.matrices()))
        o.set_challenge(_ints(1, rng)[0], _ints(3, rng), "cpu")
        return o, 4
    o = CombinedLDTOracle(F, L, [16, 8, 16, 3])
    o.set_coefficients(_ints(8, rng))
    return o, 4


def _iop_with(oracle, n_cons, rng):
    iop = IOPProtocol(F, "cpu")
    dh = iop.register_domain(L)
    cons = [iop.register_oracle(dh, 16) for _ in range(n_cons)]
    vh = iop.register_virtual_oracle(dh, 16, cons, oracle)
    evals = [F.random((L.order,), rng, "cpu") for _ in cons]
    for h, ev in zip(cons, evals):
        iop.submit_oracle(h, ev)
    return iop, vh, evals


@pytest.mark.parametrize("kind", ["rlc", "sumcheck_g", "fz", "rowcheck",
                                  "lincheck", "combined_ldt"])
def test_tape_matches_eager_evaluation(kind):
    rng = np.random.default_rng(len(kind))
    oracle, n_cons = _oracle(kind, rng)
    iop, vh, evals = _iop_with(oracle, n_cons, rng)
    got = iop.get_fused_oracle_evaluations([vh])[0]
    assert torch.equal(got, oracle.evaluated_contents(evals))


def test_shared_nodes_and_several_roots():
    """g over an RLC node, with both as roots: one tape, two outputs, each
    equal to the eager walk."""
    rng = np.random.default_rng(9)
    rlc, _ = _oracle("rlc", rng)
    g, _ = _oracle("sumcheck_g", rng)
    iops = []
    for _ in range(2):
        iop = IOPProtocol(F, "cpu")
        dh = iop.register_domain(L)
        cons = [iop.register_oracle(dh, 16) for _ in range(4)]
        rh = iop.register_virtual_oracle(dh, 16, cons[:3], rlc)
        gh = iop.register_virtual_oracle(dh, 15, [rh, cons[3]], g)
        iops.append((iop, rh, gh, cons))
    evals = [F.random((L.order,), rng, "cpu") for _ in range(4)]
    for iop, rh, gh, cons in iops:
        for h, ev in zip(cons, evals):
            iop.submit_oracle(h, ev)
    fused = iops[0][0].get_fused_oracle_evaluations([iops[0][2], iops[0][1]])
    eager = [iops[1][0].get_oracle_evaluations(h) for h in iops[1][2:0:-1]]
    assert all(torch.equal(a, b) for a, b in zip(fused, eager))


def test_tape_beyond_the_register_file_raises():
    b = TapeRecorder()
    x = b.input()
    live = [b.mul(x, x) for _ in range(MAX_REGS + 1)]
    acc = live[0]
    for v in live[1:]:
        acc = b.add(acc, v)
    with pytest.raises(ValueError, match="register file"):
        b.finish([acc])


def test_oracle_without_challenge_has_no_tape():
    rng = np.random.default_rng(3)
    iop, vh, _ = _iop_with(RandomLinearCombinationOracle(F, 2), 2, rng)
    with pytest.raises(RuntimeError, match="challenge is not set"):
        iop.get_fused_oracle_evaluations([vh])
