"""Direct low-degree test (Ligero's LDT; port of
libiop_tpu/protocols/direct_ldt.py).

After the commitment the prover sends each tested polynomial's
coefficients as a prover message; the verifier evaluates them at q random
positions of the codeword domain (kernel K10, one call per polynomial) and
compares with the oracle's revealed values; queries = ceil(sec /
-log(1 - delta)).
"""
from __future__ import annotations

import math
from typing import List

from ..algebra.generic import ifft_known_any
from ..iop.runtime import IOPProtocol, OracleHandle


class DirectLDTParams:
    def __init__(self, query_soundness_bits: int, poly_degree_bound: int,
                 RS_extra_dimensions: int, absolute_proximity_parameter: int):
        self.poly_degree_bound = poly_degree_bound
        self.codeword_domain_dim = (poly_degree_bound.bit_length() - 1
                                    + RS_extra_dimensions)
        N = 1 << self.codeword_domain_dim
        frac = absolute_proximity_parameter / N
        denom = math.log2(1 - frac)
        self.num_queries = max(1, int(math.ceil(-query_soundness_bits / denom)))


class DirectLDT:
    """The multi-LDT the LDT reducer hosts in Ligero (FRIProtocol's role)."""

    def __init__(self, iop: IOPProtocol, params: DirectLDTParams,
                 codeword_handle, poly_handles: List[OracleHandle]):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.codeword_handle = codeword_handle
        self.poly_handles = list(poly_handles)
        self.L = iop.get_domain(codeword_handle)

    def register_interactions(self):
        # an empty verifier message puts the coefficients in the round
        # after the commitment
        self.iop.register_verifier_random_message(0)
        self.coeff_handles = [
            self.iop.register_prover_message(self.params.poly_degree_bound)
            for _ in self.poly_handles]

    def register_queries(self):
        self.position_handles = [
            self.iop.register_random_query_position(self.codeword_handle)
            for _ in range(self.params.num_queries)]
        self.query_handles = [
            [self.iop.register_query(ph, pos) for ph in self.poly_handles]
            for pos in self.position_handles]

    def calculate_and_submit_proof(self):
        F = self.F
        d = self.params.poly_degree_bound
        for ph, ch in zip(self.poly_handles, self.coeff_handles):
            evals = self.iop.get_oracle_evaluations(ph)
            coeffs = ifft_known_any(evals, self.L, d)
            self.iop.submit_prover_message(
                ch, [int(v) for v in F.to_ints(coeffs[:, :d])])
        self.iop.signal_prover_round_done()

    def verifier_predicate(self) -> bool:
        from .ligero import _responses_at_positions
        F = self.F
        positions = [self.iop.obtain_query_position(ph)
                     for ph in self.position_handles]
        for i, ch in enumerate(self.coeff_handles):
            coeffs = self.iop.receive_prover_message(ch)
            vals = _responses_at_positions(
                F, F.from_ints(coeffs, self.iop.device), self.L, positions)
            for k in range(len(positions)):
                if vals[k] != self.iop.obtain_query_response(
                        self.query_handles[k][i]):
                    return False
        return True
