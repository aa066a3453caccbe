"""Aurora IOP: the encoded Aurora protocol plus the LDT instance reducer
hosting FRI (port of the multiplicative branch of
libiop_tpu/protocols/aurora.py).

Constraint and variable domains are canonical subgroups; the codeword
domain is a coset shifted by the field's multiplicative generator, so it is
disjoint from them (aurora_iop.tcc:278-291).  zk adds 2 systematic
dimensions and fixes the query bound b by iteration (aurora_iop.tcc:115-185).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..algebra.generic import element_outside_of_subset, make_domain
from ..iop.runtime import IOPProtocol, RoundParameters
from ..utils.profiling import PROFILER
from .fri import FRIParameters, FRIProtocol, FRISoundnessType
from .ldt_reducer import (LDTInstanceReducer, LDTReducerParams,
                          LDTReducerSoundnessType)
from .r1cs_rs_iop import EncodedAurora, EncodedAuroraParams


class AuroraIOPParams:
    def __init__(self, F, security_parameter: int, RS_extra_dimensions: int,
                 make_zk: bool, num_constraints: int, num_variables: int,
                 fri_localization_parameter: int = 2,
                 fri_soundness_type: str = FRISoundnessType.heuristic,
                 ldt_reducer_soundness_type: str =
                 LDTReducerSoundnessType.optimistic_heuristic,
                 pow_bits: int = 0, fri_localization_vector=None):
        assert num_constraints & (num_constraints - 1) == 0, \
            "num_constraints must be a power of two (pad the constraint system)"
        assert (num_variables + 1) & num_variables == 0, \
            "num_variables must be one less than a power of two"
        self.F = F
        self.security_parameter = security_parameter
        self.RS_extra_dimensions = RS_extra_dimensions
        self.make_zk = make_zk
        self.pow_bits = pow_bits
        self.constraint_domain_dim = num_constraints.bit_length() - 1
        self.variable_domain_dim = (num_variables + 1).bit_length() - 1
        self.summation_domain_dim = max(self.constraint_domain_dim,
                                        self.variable_domain_dim)
        self.codeword_domain_dim = (self.summation_domain_dim
                                    + (2 if make_zk else 0)
                                    + RS_extra_dimensions)
        self._fri_localization_vector = fri_localization_vector
        self._set_ldt_parameters(fri_localization_parameter,
                                 fri_soundness_type,
                                 ldt_reducer_soundness_type)

    def _set_ldt_parameters(self, localization_parameter, fri_soundness_type,
                            ldt_reducer_soundness_type):
        F = self.F
        query_bits = self.security_parameter + 1 - self.pow_bits
        interactive_bits = self.security_parameter + 3
        loc_array = (list(self._fri_localization_vector)
                     if self._fri_localization_vector is not None else
                     FRIParameters.localization_parameter_to_array(
                         localization_parameter, self.codeword_domain_dim,
                         self.RS_extra_dimensions))

        def ldt_params(query_bound: int):
            self.encoded_params = EncodedAuroraParams(
                F, interactive_bits, self.codeword_domain_dim,
                self.constraint_domain_dim, self.summation_domain_dim,
                query_bound, self.make_zk)
            tested = FRIParameters.next_testable_degree_bound(
                self.encoded_params.max_tested_degree_bound(), loc_array)
            return tested, self.encoded_params.max_constraint_degree_bound()

        def set_reducer_and_fri(tested: int, constraint: int):
            self.ldt_reducer_params = LDTReducerParams(
                F, interactive_bits, ldt_reducer_soundness_type,
                self.codeword_domain_dim, tested, constraint, self.make_zk)
            self.fri_params = FRIParameters(
                F, interactive_bits, query_bits, fri_soundness_type, tested,
                self.codeword_domain_dim, self.RS_extra_dimensions,
                self.ldt_reducer_params.absolute_proximity_parameter,
                loc_array)

        if not self.make_zk:
            self.query_bound = 0
            set_reducer_and_fri(*ldt_params(0))
            return
        # the query bound b is the number of codeword positions FRI reveals,
        # which depends on b through the tested degree: iterate to a fixed
        # point; a tested degree past the systematic part grows the domain
        estimated, last = 0, -1
        while estimated != last:
            tested, constraint = ldt_params(estimated + 1)
            if tested > 1 << (self.codeword_domain_dim
                              - self.RS_extra_dimensions):
                self.codeword_domain_dim += 1
                self._set_ldt_parameters(localization_parameter,
                                         fri_soundness_type,
                                         ldt_reducer_soundness_type)
                return
            set_reducer_and_fri(tested, constraint)
            last = estimated
            estimated = self.fri_params.num_query_repetitions << loc_array[0]
        self.query_bound = estimated + 1


class AuroraIOP:
    def __init__(self, iop: IOPProtocol, r1cs, params: AuroraIOPParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        F = self.F
        ch = iop.register_domain(make_domain(F, params.constraint_domain_dim))
        vh = iop.register_domain(make_domain(F, params.variable_domain_dim))
        self.codeword_handle = iop.register_domain(make_domain(
            F, params.codeword_domain_dim,
            shift=element_outside_of_subset(F, params.codeword_domain_dim)))
        self.protocol = EncodedAurora(iop, ch, vh, self.codeword_handle, r1cs,
                                      params.encoded_params, rng=rng)
        self.ldt_reducer = LDTInstanceReducer(iop, self.codeword_handle,
                                              params.ldt_reducer_params,
                                              rng=rng)
        first_coset = 1 << params.fri_params.localization_parameters[0]
        iop.set_round_parameters(RoundParameters(first_coset), round=0)

    def register_interactions(self):
        self.protocol.register_challenge()
        self.protocol.register_proof()
        first_coset = 1 << self.params.fri_params.localization_parameters[0]
        self.iop.set_round_parameters(RoundParameters(first_coset), round=1)
        self.ldt_reducer.set_ldt(lambda iop, cwh, combined: FRIProtocol(
            iop, self.params.fri_params, cwh, combined))
        self.ldt_reducer.register_interactions(
            self.protocol.get_all_oracle_handles())

    def register_queries(self):
        self.ldt_reducer.register_queries()

    def produce_proof(self, primary: List[int], auxiliary: List[int]):
        with PROFILER.block("witness_encode"):
            self.protocol.submit_witness_oracles(primary, auxiliary)
            self.ldt_reducer.submit_masking_polynomial()
        with PROFILER.block("round1_commit"):
            self.iop.signal_prover_round_done()
        with PROFILER.block("sumcheck_lincheck"):
            self.protocol.calculate_and_submit_proof()
        with PROFILER.block("round2_commit"):
            self.iop.signal_prover_round_done()
        with PROFILER.block("fri_ldt"):
            self.ldt_reducer.calculate_and_submit_proof()

    def verifier_predicate(self, primary: List[int]) -> bool:
        self.protocol.construct_verifier_state(primary)
        return self.ldt_reducer.verifier_predicate()
