"""Common virtual oracles and linear combinations (port of
libiop_tpu/protocols/common.py): the random linear combination and
lazy_linear_combination, and Fractal's boundary constraint and rational
linear combination (combined numerator and denominator)."""
from __future__ import annotations

from typing import List, Optional

import torch

from ..algebra.domains import device_table
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


def inverse_distance_evals(L, point: int, device) -> torch.Tensor:
    """1 / (x - point) over the domain L (point outside L), memoized per
    (domain, point) and device: one K20 launch over a prime field."""
    F = L.field

    def compute():
        diff = F.sub(L.elements(device),
                     F.from_ints([point], device).reshape(F.L, 1))
        return F.inv(diff)

    return device_table(("xinv", L._key(), point), device, compute)


class SingleBoundaryConstraint(VirtualOracle):
    """(f(x) - v) / (x - beta): proves f(beta) = v.  The inverse of
    x - beta over L enters the DAG as a memoized codeword (K20)."""

    def __init__(self, F, codeword_domain):
        self.F = F
        self.L = codeword_domain
        self.eval_point: Optional[int] = None
        self.oracle_eval: Optional[int] = None

    def set_evaluation_point_and_eval(self, beta: int, value: int):
        self.eval_point = self.F.sample_int(beta)
        self.oracle_eval = self.F.sample_int(value)

    def traced_aux(self, device):
        if self.eval_point is None:
            return None
        return [inverse_distance_evals(self.L, self.eval_point, device),
                self.oracle_eval]

    def traced_contents(self, F, aux, evals):
        dinv, v = aux
        return F.mul(F.sub(evals[0], v), dinv)

    def evaluation_at_point(self, position, x, vals):
        assert self.eval_point is not None
        F = self.F
        return F.mul_ints(F.sub_ints(vals[0], self.oracle_eval),
                          F.inv_int(F.sub_ints(x, self.eval_point)))


class CombinedDenominator(VirtualOracle):
    """The product of the constituent denominators."""

    def __init__(self, F, num_rationals: int):
        self.F = F
        self.n = num_rationals

    def traced_aux(self, device):
        return []

    def traced_sig(self):
        return (self.n,)

    def traced_contents(self, F, aux, evals):
        acc = evals[0]
        for ev in evals[1:]:
            acc = F.mul(acc, ev)
        return acc

    def evaluation_at_point(self, position, x, vals):
        acc = 1
        for v in vals:
            acc = self.F.mul_ints(acc, v)
        return acc


class CombinedNumerator(VirtualOracle):
    """sum_i c_i N_i prod_{j != i} D_j; constituents (N_0..N_{n-1},
    D_0..D_{n-1})."""

    def __init__(self, F, num_rationals: int):
        self.F = F
        self.n = num_rationals
        self.coefficients: Optional[List[int]] = None

    def set_coefficients(self, coeffs):
        assert len(coeffs) == self.n
        self.coefficients = [self.F.sample_int(int(c)) for c in coeffs]

    def traced_aux(self, device):
        return None if self.coefficients is None else list(self.coefficients)

    def traced_sig(self):
        return (self.n,)

    def traced_contents(self, F, aux, evals):
        nums, dens = evals[:self.n], evals[self.n:]
        acc = None
        for i in range(self.n):
            term = F.mul(nums[i], aux[i])
            for j in range(self.n):
                if j != i:
                    term = F.mul(term, dens[j])
            acc = term if acc is None else F.add(acc, term)
        return acc

    def evaluation_at_point(self, position, x, vals):
        assert self.coefficients is not None
        F = self.F
        nums, dens = vals[:self.n], vals[self.n:]
        total = 0
        for i in range(self.n):
            cur = F.mul_ints(self.coefficients[i], nums[i])
            for j in range(self.n):
                if j != i:
                    cur = F.mul_ints(cur, dens[j])
            total = F.add_ints(total, cur)
        return total


class RationalLinearCombination:
    """Wires the combined numerator and denominator virtual oracles of
    sum_i c_i N_i / D_i."""

    def __init__(self, iop, num_rationals: int, numerator_handles,
                 denominator_handles, codeword_handle,
                 numerator_degree: int, denominator_degree: int):
        self.iop = iop
        self.F = iop.F
        self.n = num_rationals
        self.numerator_oracle = CombinedNumerator(self.F, num_rationals)
        self.denominator_oracle = CombinedDenominator(self.F, num_rationals)
        self.numerator_handle = iop.register_virtual_oracle(
            codeword_handle, numerator_degree,
            list(numerator_handles) + list(denominator_handles),
            self.numerator_oracle)
        self.denominator_handle = iop.register_virtual_oracle(
            codeword_handle, denominator_degree, list(denominator_handles),
            self.denominator_oracle)

    def set_coefficients(self, coeffs):
        self.numerator_oracle.set_coefficients(coeffs)

    @staticmethod
    def values_over_K(F, coeff_ints, numerators_over_K, denominators_over_K):
        """sum_i c_i N_i(k) / D_i(k) over K (the prover's rational sumcheck
        input): each N_i / D_i one K20 launch, the inverse fused with the
        product by N_i (over GF(2^k) a K16 inverse and product)."""
        acc = None
        for c, n_ev, d_ev in zip(coeff_ints, numerators_over_K,
                                 denominators_over_K):
            term = F.mul(F.batch_inverse_and_mul(d_ev, n_ev),
                         F.scalar(c, n_ev))
            acc = term if acc is None else F.add(acc, term)
        return acc
