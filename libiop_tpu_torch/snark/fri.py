"""FRI SNARK over random low-degree oracles (port of libiop_tpu/snark/fri.py).

Counterpart of libiop/snark/fri_snark.{hpp,tcc} with the dummy protocol
(protocols/encoded/dummy_protocol.hpp:20-60): commits ``num_oracles``
random RS codewords (each an NTT of random coefficients, kernel K2) in one
round-0 tree and runs multi-FRI on them (K4) through the BCS transform,
the FRI-isolation benchmark.  Prime fields only, as the reference's.

``fri_snark_prover`` / ``fri_snark_verifier`` take the reference's
arguments plus ``device=`` (default "cuda"; "cpu" runs the plain PyTorch
path).  The proof bytes are the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..algebra.fft import fft
from ..algebra.generic import element_outside_of_subset, make_domain
from ..bcs.common import BCSParameters, BCSTranscript
from ..bcs.prover import BCSProver
from ..bcs.verifier import BCSVerificationError, BCSVerifier
from ..device import resolve_device
from ..iop.runtime import RoundParameters
from ..protocols.fri import FRIParameters, FRIProtocol, FRISoundnessType


@dataclasses.dataclass
class FRISnarkParams:
    security_parameter: int = 128
    codeword_domain_dim: int = 12
    RS_extra_dimensions: int = 2
    localization_parameter: int = 2
    #: explicit per-round localization vector; overrides
    #: localization_parameter when set (instrument_fri_snark.cpp:90-96
    #: num_localization_steps role)
    localization_vector: Optional[List[int]] = None
    num_oracles: int = 1
    hash_name: str = "blake2b"
    pow_bits: int = 0
    override_fri_queries: Optional[int] = None
    override_fri_interactive_repetitions: Optional[int] = None

    def fri_params(self, F) -> FRIParameters:
        degree = 1 << (self.codeword_domain_dim - self.RS_extra_dimensions)
        if self.localization_vector is not None:
            loc = list(self.localization_vector)
        else:
            loc = FRIParameters.localization_parameter_to_array(
                self.localization_parameter, self.codeword_domain_dim,
                self.RS_extra_dimensions)
        degree = FRIParameters.next_testable_degree_bound(degree, loc)
        p = FRIParameters(
            F, self.security_parameter + 3,
            self.security_parameter + 1 - self.pow_bits,
            FRISoundnessType.heuristic, degree, self.codeword_domain_dim,
            self.RS_extra_dimensions,
            (1 << self.codeword_domain_dim) // 4, loc)
        if self.override_fri_queries is not None:
            p.num_query_repetitions = self.override_fri_queries
        if self.override_fri_interactive_repetitions is not None:
            p.num_interactive_repetitions = \
                self.override_fri_interactive_repetitions
        return p

    def bcs_params(self) -> BCSParameters:
        return BCSParameters(self.security_parameter, self.hash_name,
                             self.pow_bits)


def _build(iop, F, params: FRISnarkParams):
    fri_params = params.fri_params(F)
    domain = make_domain(F, params.codeword_domain_dim,
                         shift=element_outside_of_subset(
                             F, params.codeword_domain_dim))
    cw = iop.register_domain(domain)
    degree = fri_params.poly_degree_bound
    handles = [iop.register_oracle(cw, degree)
               for _ in range(params.num_oracles)]
    iop.set_round_parameters(RoundParameters(
        1 << fri_params.localization_parameters[0]), round=0)
    fri = FRIProtocol(iop, fri_params, cw, handles)
    fri.register_interactions()
    iop.seal_interaction_registrations()
    fri.register_queries()
    iop.seal_query_registrations()
    return fri, domain, handles, degree


def fri_snark_prover(F, params: FRISnarkParams,
                     rng: Optional[np.random.Generator] = None,
                     device="cuda") -> BCSTranscript:
    """Commit ``params.num_oracles`` random codewords of degree below the
    FRI bound (coefficients from ``rng``, in the reference's draw order)
    and prove their proximity by multi-FRI."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng()
    iop = BCSProver(F, params.bcs_params(), dev)
    fri, domain, handles, degree = _build(iop, F, params)
    for h in handles:
        iop.submit_oracle(h, fft(F.random((degree,), rng, dev), domain))
    iop.signal_prover_round_done()
    fri.calculate_and_submit_proof()
    return iop.get_transcript()


def fri_snark_verifier(F, transcript: BCSTranscript, params: FRISnarkParams,
                       device="cuda") -> bool:
    dev = resolve_device(device)
    iop = BCSVerifier(F, params.bcs_params(), transcript, dev)
    fri, _, _, _ = _build(iop, F, params)
    if not iop.transcript_is_valid():
        return False
    iop.finalize_query_positions()
    try:
        return fri.verifier_predicate()
    except BCSVerificationError:
        return False
