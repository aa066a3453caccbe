"""Rational sumcheck over the index domain K (port of
libiop_tpu/protocols/rational_sumcheck.py, both domain families): the
prover sends the re-extension p of N/D over K with one coefficient
dropped, the one that encodes the claimed sum mu:
* multiplicative: the constant one (mu = |K| c_0); the constraint is
  q(x) = (D(x) (x p(x) + mu/|K|) - N(x)) / Z_K(x);
* additive: the top one (mu = eps c_{|K|-1}, eps the x coefficient of
  K's linearized Z_K); the constraint is
  q(x) = (D(x) (p(x) + eps^-1 mu x^(|K|-1)) - N(x)) / Z_K(x).
"""
from __future__ import annotations

from typing import Optional

from ..algebra.domains import device_table
from ..algebra.generic import (fft_any, ifft_any, is_additive,
                               linearized_vanishing, vanishing_eval_int,
                               vanishing_inverse_evals_over_any)
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle


class SumcheckConstraintOracle(VirtualOracle):
    """Constituents: (p, N, D)."""

    def __init__(self, F, K, L):
        self.F = F
        self.K = K
        self.L = L
        self.additive = is_additive(K)
        self.claimed_sum: Optional[int] = None

    def set_claimed_sum(self, mu: int):
        F = self.F
        self.claimed_sum = F.sample_int(mu)
        scale = linearized_vanishing(self.K).epsilon if self.additive \
            else self.K.order % F.p
        self.mu_scaled = F.mul_ints(self.claimed_sum, F.inv_int(scale))

    def traced_aux(self, device):
        """[1/Z_K over L, x over L (x^(|K|-1) over a subspace), the scaled
        claimed sum]."""
        if self.claimed_sum is None:
            return None
        K, L = self.K, self.L
        if self.additive:
            x = device_table(
                ("x_pow", L._key(), K.order - 1), device,
                lambda: K.field.pow_static(L.elements(device), K.order - 1))
        else:
            x = L.elements(device)
        return [vanishing_inverse_evals_over_any(K, L, device), x,
                self.mu_scaled]

    def traced_sig(self):
        return (self.additive,)

    def traced_contents(self, F, aux, evals):
        z_inv, x, mu = aux
        p_evals, n_evals, d_evals = evals
        if self.additive:
            inner = F.add(p_evals, F.mul(x, mu))
        else:
            inner = F.add(F.mul(x, p_evals), mu)
        return F.mul(F.sub(F.mul(d_evals, inner), n_evals), z_inv)

    def evaluation_at_point(self, position, x, vals):
        assert self.claimed_sum is not None
        F = self.F
        p_x, n_x, d_x = vals
        if self.additive:
            inner = F.add_ints(p_x, F.mul_ints(
                self.mu_scaled, F.pow_int(x, self.K.order - 1)))
        else:
            inner = F.add_ints(F.mul_ints(x, p_x), self.mu_scaled)
        return F.mul_ints(F.sub_ints(F.mul_ints(d_x, inner), n_x),
                          F.inv_int(vanishing_eval_int(self.K, x)))


class RationalSumcheck:
    def __init__(self, iop: IOPProtocol, summation_handle, codeword_handle,
                 numerator_degree_bound: int, denominator_degree_bound: int):
        self.iop = iop
        self.F = iop.F
        self.K = iop.get_domain(summation_handle)
        self.L = iop.get_domain(codeword_handle)
        self.codeword_handle = codeword_handle
        self.reextended_degree = self.K.order - 1
        self.constraint_degree = max(
            numerator_degree_bound,
            denominator_degree_bound + self.K.order - 1) - self.K.order
        self.claimed_sum: Optional[int] = None

    def register_summation_oracle(self, numerator_handle: OracleHandle,
                                  denominator_handle: OracleHandle):
        self.numerator_handle = numerator_handle
        self.denominator_handle = denominator_handle

    def register_proof(self):
        self.reextended_handle = self.iop.register_oracle(
            self.codeword_handle, self.reextended_degree, make_zk=False)
        self.constraint_oracle = SumcheckConstraintOracle(self.F, self.K,
                                                          self.L)
        self.constraint_handle = self.iop.register_virtual_oracle(
            self.codeword_handle, self.constraint_degree,
            [self.reextended_handle, self.numerator_handle,
             self.denominator_handle], self.constraint_oracle)

    def calculate_and_submit_proof(self, rational_over_K):
        """rational_over_K: (L, |K|) values of N/D over K (natural order)."""
        F = self.F
        coeffs = ifft_any(rational_over_K, self.K)
        if self.constraint_oracle.additive:
            top = int(F.to_ints(coeffs[:, -1:])[0])
            self.claimed_sum = F.mul_ints(
                linearized_vanishing(self.K).epsilon, top)
            reext = coeffs[:, :-1]
        else:
            c0 = int(F.to_ints(coeffs[:, :1])[0])
            self.claimed_sum = F.mul_ints(c0, self.K.order % F.p)
            reext = coeffs[:, 1:]
        self.iop.submit_oracle(self.reextended_handle,
                               fft_any(reext.contiguous(), self.L))
        self.constraint_oracle.set_claimed_sum(self.claimed_sum)

    def get_claimed_sum(self) -> int:
        return self.claimed_sum

    def construct_verifier_state(self, claimed_sum: int):
        self.claimed_sum = self.F.sample_int(claimed_sum)
        self.constraint_oracle.set_claimed_sum(self.claimed_sum)

    def ldt_oracle_handles(self):
        return [self.reextended_handle, self.constraint_handle]
