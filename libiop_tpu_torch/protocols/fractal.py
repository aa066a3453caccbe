"""Fractal holographic IOP: indexed matrices, the holographic encoded
Aurora, and the LDT reducer hosting FRI (port of
libiop_tpu/protocols/fractal.py).

* the matrices are square with a power-of-two size;
* index domain dim = log2(max nnz over A, B, C) (at least the matrix
  domain's);
* codeword domain dim = log2(4 |K|) + RS_extra, grown while the tested
  degree does not fit;
* the security split mirrors Aurora's (query +1 - pow, interactive +3), the
  zk query bound a fixed point over FRI's query count.

Round 0 holds the twelve index oracles; ``produce_index`` computes and
commits them, ``get_index_artifact`` persists them with their K-vectors
and Merkle trees, and ``submit_index`` reinstalls that artifact so a proof
hashes nothing in round 0.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..algebra.generic import element_outside_of_subset, make_domain
from ..iop.runtime import IOPProtocol, OracleHandle, RoundParameters
from .fractal_indexer import MatrixIndexer
from .fri import FRIParameters, FRIProtocol, FRISoundnessType
from .ldt_reducer import (LDTInstanceReducer, LDTReducerParams,
                          LDTReducerSoundnessType)
from .r1cs_rs_iop import EncodedAurora, EncodedAuroraParams


class FractalIOPParams:
    def __init__(self, F, security_parameter: int, pow_bits: int,
                 RS_extra_dimensions: int, make_zk: bool, r1cs,
                 fri_localization_parameter: int = 2,
                 fri_soundness_type: str = FRISoundnessType.heuristic,
                 ldt_reducer_soundness_type: str =
                 LDTReducerSoundnessType.optimistic_heuristic):
        m = r1cs.num_constraints
        assert m & (m - 1) == 0, "Fractal needs a power-of-two #constraints"
        assert m == r1cs.num_variables + 1, "Fractal needs square matrices"
        self.F = F
        self.security_parameter = security_parameter
        self.pow_bits = pow_bits
        self.RS_extra_dimensions = RS_extra_dimensions
        self.make_zk = make_zk
        max_nnz = max(len(M.rows) for M in r1cs.matrices())
        self.index_domain_dim = max((max(max_nnz, 1) - 1).bit_length(),
                                    m.bit_length() - 1)
        self.matrix_domain_dim = m.bit_length() - 1
        max_tested = 4 << self.index_domain_dim
        self.codeword_domain_dim = (max_tested.bit_length() - 1) + \
            RS_extra_dimensions
        self._set_ldt_parameters(fri_localization_parameter,
                                 fri_soundness_type,
                                 ldt_reducer_soundness_type)

    def _set_ldt_parameters(self, localization_parameter, fri_soundness_type,
                            ldt_reducer_soundness_type):
        F = self.F
        query_bits = self.security_parameter + 1 - self.pow_bits
        interactive_bits = self.security_parameter + 3
        estimated, last = 0, -1
        while estimated != last:
            loc_array = FRIParameters.localization_parameter_to_array(
                localization_parameter, self.codeword_domain_dim,
                self.RS_extra_dimensions)
            query_bound = estimated if self.make_zk else 0
            self.encoded_params = EncodedAuroraParams(
                F, interactive_bits, self.codeword_domain_dim,
                self.matrix_domain_dim, self.matrix_domain_dim, query_bound,
                self.make_zk, holographic=True,
                index_domain_dim=self.index_domain_dim)
            tested = FRIParameters.next_testable_degree_bound(
                self.encoded_params.max_tested_degree_bound(), loc_array)
            constraint = self.encoded_params.max_constraint_degree_bound()
            if tested > 1 << (self.codeword_domain_dim
                              - self.RS_extra_dimensions):
                self.codeword_domain_dim += 1
                estimated, last = 0, -1
                continue
            self.ldt_reducer_params = LDTReducerParams(
                F, interactive_bits, ldt_reducer_soundness_type,
                self.codeword_domain_dim, tested, constraint, self.make_zk)
            self.fri_params = FRIParameters(
                F, interactive_bits, query_bits, fri_soundness_type, tested,
                self.codeword_domain_dim, self.RS_extra_dimensions,
                self.ldt_reducer_params.absolute_proximity_parameter,
                loc_array)
            last = estimated
            estimated = self.fri_params.num_query_repetitions << loc_array[0]
            if not self.make_zk:
                break
        self.query_bound = estimated if self.make_zk else 0


class FractalIOP:
    def __init__(self, iop: IOPProtocol, r1cs, params: FractalIOPParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.r1cs = r1cs
        F = self.F
        index_domain = make_domain(F, params.index_domain_dim)
        matrix_domain = make_domain(F, params.matrix_domain_dim)
        codeword_domain = make_domain(
            F, params.codeword_domain_dim,
            shift=element_outside_of_subset(F, params.codeword_domain_dim))
        self.index_handle = iop.register_domain(index_domain)
        self.matrix_handle = iop.register_domain(matrix_domain)
        self.codeword_handle = iop.register_domain(codeword_domain)
        first_coset = 1 << params.fri_params.localization_parameters[0]
        input_dim = (r1cs.num_inputs + 1).bit_length() - 1
        self.indexers: List[MatrixIndexer] = []
        indexed_handles = []
        for M in r1cs.matrices():
            idxr = MatrixIndexer(iop, self.index_handle, self.matrix_handle,
                                 self.codeword_handle, input_dim, M)
            idxr.register_oracles()
            self.indexers.append(idxr)
            indexed_handles.append(idxr.get_all_oracle_handles())
        iop.set_round_parameters(RoundParameters(first_coset), round=0)
        self.protocol = EncodedAurora(iop, self.matrix_handle,
                                      self.matrix_handle,
                                      self.codeword_handle, r1cs,
                                      params.encoded_params, rng=rng)
        self.protocol.set_index_oracles(self.index_handle, indexed_handles)
        self.ldt_reducer = LDTInstanceReducer(
            iop, self.codeword_handle, params.ldt_reducer_params, rng=rng)
        iop.set_round_parameters(RoundParameters(first_coset), round=1)

    def register_interactions(self):
        first_coset = 1 << self.params.fri_params.localization_parameters[0]
        self.protocol.register_challenge()
        self.iop.set_round_parameters(RoundParameters(first_coset), round=2)
        self.protocol.register_proof()
        self.iop.set_round_parameters(RoundParameters(first_coset), round=3)
        handles = self.protocol.get_all_oracle_handles()
        self.ldt_reducer.set_ldt(lambda iop, cwh, combined: FRIProtocol(
            iop, self.params.fri_params, cwh, combined))
        self.ldt_reducer.register_interactions(handles)

    def register_queries(self):
        self.ldt_reducer.register_queries()

    # -- index phase -------------------------------------------------------
    def produce_index(self):
        """Compute and submit the round-0 index oracles and hand the
        K-vectors to the lincheck (each matrix's computed once)."""
        vectors = [idxr.compute_oracles(self.iop.device)
                   for idxr in self.indexers]
        self.protocol.set_index_vectors_over_K(vectors)
        self.iop.signal_prover_round_done()

    def submit_index(self, index_artifact):
        """Reinstall a persisted index (evals, K-vectors, round-0 Merkle
        data); its trees are preloaded into the BCS prover, so round 0
        costs no hashing."""
        evals_map, vectors, mt_data = index_artifact
        if mt_data:
            self.iop.preload_index_trees(mt_data)
        for oid, ev in evals_map.items():
            self.iop.submit_oracle(OracleHandle(oid), ev)
        self.protocol.set_index_vectors_over_K(vectors)
        self.iop.signal_prover_round_done()

    def get_index_artifact(self):
        """The persistent prover index: the round-0 oracles' evaluations,
        the K-vectors and the round-0 Merkle data {(0, domain id): (leaf
        blocks, node heap)}, empty for an interactive engine."""
        evals_map = {i: self.iop.oracle_evals[i]
                     for i, reg in enumerate(self.iop.oracle_regs)
                     if reg.is_index}
        mt_data = {key: (self.iop.mt_leaf_blocks[key], mt.heap)
                   for key, mt in getattr(self.iop, "merkle_trees", {}).items()
                   if key[0] == 0}
        return (evals_map, self.protocol.multi_lincheck._index_vectors,
                mt_data)

    # -- prove / verify ----------------------------------------------------
    def produce_proof(self, primary: List[int], auxiliary: List[int]):
        """Assumes the index round was submitted and signalled."""
        self.protocol.submit_witness_oracles(primary, auxiliary)
        self.ldt_reducer.submit_masking_polynomial()
        self.iop.signal_prover_round_done()
        self.protocol.calculate_and_submit_proof()
        self.iop.signal_prover_round_done()
        self.ldt_reducer.calculate_and_submit_proof()

    def verifier_predicate(self, primary: List[int]) -> bool:
        self.protocol.construct_verifier_state(primary)
        return self.ldt_reducer.verifier_predicate()
