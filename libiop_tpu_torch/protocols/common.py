"""Common virtual oracles (port of the random linear combination of
libiop_tpu/protocols/common.py)."""
from __future__ import annotations

from typing import List, Optional

from ..iop.runtime import VirtualOracle


class RandomLinearCombinationOracle(VirtualOracle):
    """sum_i c_i f_i; coefficients set after the verifier's challenge."""

    def __init__(self, F, num_oracles: int):
        self.F = F
        self.num_oracles = num_oracles
        self.coefficients: Optional[List[int]] = None

    def set_coefficients(self, coeffs: List[int]):
        assert len(coeffs) == self.num_oracles
        self.coefficients = [self.F.sample_int(int(c)) for c in coeffs]

    def traced_aux(self, device):
        return None if self.coefficients is None else list(self.coefficients)

    def traced_contents(self, F, aux, evals):
        acc = None
        for c, ev in zip(aux, evals):
            term = F.mul(ev, c)
            acc = term if acc is None else F.add(acc, term)
        return acc

    def evaluation_at_point(self, position, point_int, vals):
        assert self.coefficients is not None, "challenge not yet set"
        F = self.F
        acc = 0
        for c, v in zip(self.coefficients, vals):
            acc = F.add_ints(acc, F.mul_ints(c, v))
        return acc
