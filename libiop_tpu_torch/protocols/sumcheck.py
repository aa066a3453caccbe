"""Univariate batch sumcheck (port of libiop_tpu/protocols/sumcheck.py).

Claim: sum over H of f equals mu.  Over a multiplicative subgroup the
prover writes f = Z_H*h + x*g + mu/|H| and sends h; the verifier
reconstructs g(x) = (f(x) - mu/|H| - Z_H(x) h(x)) * x^-1.  Over an affine
subspace g(x) = f(x) - eps^-1 mu x^(|H|-1) - Z_H(x) h(x), eps the linear
coefficient of the linearized Z_H.  Claims are batched by a random linear
combination.  With zk a random masking polynomial that sums to 0 over H
(Z_H*h' + g' with g'(0) = 0, or with the x^(|H|-1) coefficient of g'
zeroed over a subspace) joins the combination as its first term, with its
own challenge coefficient.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..algebra.generic import (divide_by_vanishing_any, fft_any,
                               ifft_known_any, is_additive,
                               linearized_vanishing, mul_by_vanishing_any,
                               vanishing_evals_over_any)
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from .common import RandomLinearCombinationOracle
from .ldt_reducer import x_power_evals


class SumcheckGOracle(VirtualOracle):
    """g(x) = (f(x) - mu/|H| - Z_H(x) h(x)) * x^-1 over a subgroup;
    g(x) = f(x) - eps^-1 mu x^(|H|-1) - Z_H(x) h(x) over a subspace."""

    def __init__(self, F, summation_domain, codeword_domain):
        self.F = F
        self.H = summation_domain
        self.L = codeword_domain
        self.additive = is_additive(summation_domain)
        self.claimed_sum: Optional[int] = None

    def set_claimed_sum(self, mu: int):
        F = self.F
        self.claimed_sum = F.sample_int(mu)
        scale = linearized_vanishing(self.H).epsilon if self.additive \
            else self.H.order % F.p
        self.mu_scaled = F.mul_ints(self.claimed_sum, F.inv_int(scale))

    def traced_aux(self, device):
        if self.claimed_sum is None:
            return None
        z = vanishing_evals_over_any(self.H, self.L, device)
        if self.additive:
            return [z, x_power_evals(self.F, self.L, self.H.order - 1, device),
                    self.mu_scaled]
        return [z, self.L.inverse_elements(device), self.mu_scaled]

    def traced_sig(self):
        return (self.additive,)

    def traced_contents(self, F, aux, evals):
        f_evals, h_evals = evals
        if self.additive:
            z, xpow, mu = aux
            return F.sub(F.sub(f_evals, F.mul(xpow, mu)), F.mul(z, h_evals))
        z, inv_x, mu = aux
        return F.mul(F.sub(F.sub(f_evals, mu), F.mul(z, h_evals)), inv_x)

    def evaluation_at_point(self, position, x, vals):
        assert self.claimed_sum is not None, "claimed sum not set"
        F = self.F
        f_x, h_x = vals
        if self.additive:
            z_x = linearized_vanishing(self.H).eval_at_point_int(x)
            t = F.mul_ints(self.mu_scaled, F.pow_int(x, self.H.order - 1))
            return F.sub_ints(F.sub_ints(f_x, t), F.mul_ints(z_x, h_x))
        p = F.p
        z_x = (pow(x, self.H.order, p) - pow(self.H.shift, self.H.order, p)) % p
        return (f_x - self.mu_scaled - z_x * h_x) * pow(x, p - 2, p) % p


class BatchSumcheck:
    """Registration and proving of one batch-sumcheck instance."""

    def __init__(self, iop: IOPProtocol, summation_handle, codeword_handle,
                 degree_bound: int, make_zk: bool,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.summation_handle = summation_handle
        self.codeword_handle = codeword_handle
        self.H = iop.get_domain(summation_handle)
        self.L = iop.get_domain(codeword_handle)
        self.additive = is_additive(self.H)
        self.degree_bound = degree_bound
        self.make_zk = make_zk
        self.rng = rng or np.random.default_rng()
        self.g_degree = self.H.order - 1
        self.h_degree = degree_bound - self.H.order
        self.attached_handles: List[OracleHandle] = []
        self.claimed_sums: List[int] = []
        self.masking_handle: Optional[OracleHandle] = None

    def register_masking_polynomial(self):
        self.masking_handle = self.iop.register_oracle(
            self.codeword_handle, self.degree_bound, make_zk=self.make_zk)

    def attach_oracle_for_summing(self, handle: OracleHandle,
                                  claimed_sum: int = 0):
        self.attached_handles.append(handle)
        self.claimed_sums.append(self.F.sample_int(claimed_sum))

    def register_challenge(self):
        self.challenge_handle = self.iop.register_verifier_random_message(
            len(self.attached_handles) + (1 if self.make_zk else 0))

    def register_proof(self):
        self.h_handle = self.iop.register_oracle(self.codeword_handle,
                                                 self.h_degree)
        constituents = ([self.masking_handle] if self.make_zk else []) \
            + list(self.attached_handles)
        self.combined_f_oracle = RandomLinearCombinationOracle(
            self.F, len(constituents))
        self.combined_f_handle = self.iop.register_virtual_oracle(
            self.codeword_handle, self.degree_bound, constituents,
            self.combined_f_oracle)
        self.g_oracle = SumcheckGOracle(self.F, self.H, self.L)
        self.g_handle = self.iop.register_virtual_oracle(
            self.codeword_handle, self.g_degree,
            [self.combined_f_handle, self.h_handle], self.g_oracle)

    def submit_masking_polynomial(self):
        """A random polynomial of degree < degree_bound summing to 0 over H:
        Z_H * h' + g' with g'(0) = 0 (for a multiplicative H the sum over H
        is |H| * g'(0)) or with g's x^(|H|-1) coefficient zeroed (an
        additive H), drawn from the prover's rng as the reference does."""
        assert self.make_zk
        F = self.F
        dev = self.iop.device
        g_coeffs = F.random((self.H.order,), self.rng, dev)
        h_coeffs = F.random((max(self.h_degree, 1),), self.rng, dev)
        g_coeffs[:, self.H.order - 1 if self.additive else 0] = 0
        m = mul_by_vanishing_any(h_coeffs, self.H)
        if self.additive:
            m = m[:, :self.degree_bound].contiguous()
        m[:, :self.H.order] = F.add(m[:, :self.H.order], g_coeffs)
        self.iop.submit_oracle(self.masking_handle, fft_any(m, self.L))

    def _combined_claimed_sum(self, challenge: List[int]) -> int:
        """The masking polynomial (zk, challenge[0]) sums to 0."""
        F = self.F
        acc = 0
        for c, s in zip(challenge[1 if self.make_zk else 0:],
                        self.claimed_sums):
            acc = F.add_ints(acc, F.mul_ints(c, s))
        return acc

    def calculate_and_submit_proof(self):
        F = self.F
        challenge = self.iop.obtain_verifier_random_message(self.challenge_handle)
        self.combined_f_oracle.set_coefficients(challenge)
        combined_evals = self.iop.get_fused_oracle_evaluations(
            [self.combined_f_handle])[0]
        coeffs = ifft_known_any(combined_evals, self.L, self.degree_bound)
        coeffs = coeffs[:, :max(self.degree_bound, 1)].contiguous()
        self.g_oracle.set_claimed_sum(self._combined_claimed_sum(challenge))
        quotient, _rem = divide_by_vanishing_any(coeffs, self.H)
        dev = coeffs.device
        if quotient.shape[1] == 0:
            quotient = F.zeros((1,), dev)
        d = 1 << (max(quotient.shape[1], 1) - 1).bit_length()
        if quotient.shape[1] != d:
            quotient = torch.cat(
                [quotient, F.zeros((d - quotient.shape[1],), dev)], dim=1)
        self.iop.submit_oracle(self.h_handle, fft_any(quotient, self.L))

    def construct_verifier_state(self):
        challenge = self.iop.obtain_verifier_random_message(self.challenge_handle)
        self.combined_f_oracle.set_coefficients(challenge)
        self.g_oracle.set_claimed_sum(self._combined_claimed_sum(challenge))

    def ldt_oracle_handles(self) -> List[OracleHandle]:
        return ([self.masking_handle] if self.make_zk else []) + \
            [self.h_handle, self.g_handle]
