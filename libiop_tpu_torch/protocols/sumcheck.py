"""Univariate batch sumcheck over a multiplicative subgroup (port of the
multiplicative branch of libiop_tpu/protocols/sumcheck.py).

Claim: sum over H of f equals mu.  The prover writes f = Z_H*h + x*g + mu/|H|
and sends h; the verifier reconstructs g virtually:
g(x) = (f(x) - mu/|H| - Z_H(x) h(x)) * x^-1.  Claims are batched by a random
linear combination.  With zk a random masking polynomial that sums to 0
over H (Z_H*h' + g' with g'(0) = 0) joins the combination as its first
term, with its own challenge coefficient.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..algebra.generic import (divide_by_vanishing_any, fft_any,
                               ifft_known_any, vanishing_evals_over_any)
from ..algebra.poly import mul_by_vanishing
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from .common import RandomLinearCombinationOracle


class SumcheckGOracle(VirtualOracle):
    """g(x) = (f(x) - mu/|H| - Z_H(x) h(x)) * x^-1."""

    def __init__(self, F, summation_domain, codeword_domain):
        self.F = F
        self.H = summation_domain
        self.L = codeword_domain
        self.claimed_sum: Optional[int] = None

    def set_claimed_sum(self, mu: int):
        F = self.F
        self.claimed_sum = F.sample_int(mu)
        self.mu_scaled = F.mul_ints(self.claimed_sum,
                                    F.inv_int(self.H.order % F.p))

    def traced_aux(self, device):
        if self.claimed_sum is None:
            return None
        return [vanishing_evals_over_any(self.H, self.L, device),
                self.L.inverse_elements(device), self.mu_scaled]

    def traced_contents(self, F, aux, evals):
        z, inv_x, mu = aux
        f_evals, h_evals = evals
        return F.mul(F.sub(F.sub(f_evals, mu), F.mul(z, h_evals)), inv_x)

    def evaluation_at_point(self, position, x, vals):
        assert self.claimed_sum is not None, "claimed sum not set"
        p = self.F.p
        f_x, h_x = vals
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
        is |H| * g'(0)), drawn from the prover's rng as the reference does."""
        assert self.make_zk
        F = self.F
        dev = self.iop.device
        g_coeffs = F.random((self.H.order,), self.rng, dev)
        h_coeffs = F.random((max(self.h_degree, 1),), self.rng, dev)
        g_coeffs[:, 0] = 0
        m = mul_by_vanishing(h_coeffs, self.H)
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
