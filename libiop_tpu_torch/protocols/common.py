"""Common virtual oracles and linear combinations (port of the random
linear combination and lazy_linear_combination of
libiop_tpu/protocols/common.py)."""
from __future__ import annotations

from typing import List, Optional

import torch

from ..fields.binary import xor_reduce
from ..iop.runtime import VirtualOracle
from ..kernels.row_dot import row_dot


def lazy_linear_combination(F, coeff_ints: List[int],
                            rows: torch.Tensor) -> torch.Tensor:
    """sum_i c_i * rows[:, i, :] for rows (L, R, N) and R canonical host
    ints c_i: one row inner product with a scalar per row (kernel K15 on
    the card: the wide products summed lazily, one reduction); over a
    binary field K16 products XOR-accumulated."""
    assert len(coeff_ints) == rows.shape[1]
    coeffs = F.from_ints(list(coeff_ints), rows.device).reshape(
        F.L, len(coeff_ints), 1)
    if F.kind == "additive":
        return xor_reduce(F.mul(rows, coeffs), dim=1)
    return row_dot(F, rows.contiguous(), coeffs)


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
