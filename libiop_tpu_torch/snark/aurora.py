"""Aurora SNARK: the BCS-compiled non-interactive argument (port of
libiop_tpu/snark/aurora.py; BLAKE2b or Poseidon, zk or not).

``aurora_snark_prover`` / ``aurora_snark_verifier`` take the reference's
arguments plus ``device=`` (default "cuda"; "cpu" runs the plain PyTorch
path).  The proof bytes are the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..bcs.common import BCSParameters, BCSTranscript
from ..bcs.prover import BCSProver
from ..bcs.verifier import BCSVerificationError, BCSVerifier
from ..device import resolve_device
from ..protocols.aurora import AuroraIOP, AuroraIOPParams
from ..protocols.fri import FRISoundnessType
from ..protocols.ldt_reducer import LDTReducerSoundnessType
from ..utils.profiling import PROFILER


@dataclasses.dataclass
class AuroraSnarkParams:
    security_parameter: int = 128
    RS_extra_dimensions: int = 3
    fri_localization_parameter: int = 2
    make_zk: bool = False
    hash_name: str = "blake2b"
    pow_bits: int = 0
    fri_soundness_type: str = FRISoundnessType.heuristic
    ldt_reducer_soundness_type: str = LDTReducerSoundnessType.optimistic_heuristic
    fri_localization_vector: Optional[list] = None
    override_fri_queries: Optional[int] = None
    override_fri_interactive_repetitions: Optional[int] = None
    override_ldt_instances: Optional[int] = None

    def iop_params(self, F, num_constraints: int,
                   num_variables: int) -> AuroraIOPParams:
        p = AuroraIOPParams(
            F, self.security_parameter, self.RS_extra_dimensions, self.make_zk,
            num_constraints, num_variables, self.fri_localization_parameter,
            self.fri_soundness_type, self.ldt_reducer_soundness_type,
            self.pow_bits, fri_localization_vector=self.fri_localization_vector)
        if self.override_fri_queries is not None:
            p.fri_params.num_query_repetitions = self.override_fri_queries
        if self.override_fri_interactive_repetitions is not None:
            p.fri_params.num_interactive_repetitions = \
                self.override_fri_interactive_repetitions
        if self.override_ldt_instances is not None:
            p.ldt_reducer_params.num_output_LDT_instances = \
                self.override_ldt_instances
        return p

    def bcs_params(self) -> BCSParameters:
        return BCSParameters(security_bits=self.security_parameter,
                             hash_name=self.hash_name, pow_bits=self.pow_bits)


def aurora_snark_prover(r1cs, primary: List[int], auxiliary: List[int],
                        params: AuroraSnarkParams,
                        rng: Optional[np.random.Generator] = None,
                        device="cuda") -> BCSTranscript:
    """Prove r1cs satisfiability.  ``rng`` is the reference's argument: with
    ``params.make_zk`` the masking and blinding polynomials draw from it
    (a fresh unseeded generator when None); the non-zk path draws nothing.
    zk Merkle salts come from ``secrets.token_bytes``, as the reference's."""
    dev = resolve_device(device)
    F = r1cs.F
    iop = BCSProver(F, params.bcs_params(), dev)
    with PROFILER.block("registration"):
        aurora = AuroraIOP(iop, r1cs, params.iop_params(
            F, r1cs.num_constraints, r1cs.num_variables), rng=rng)
        aurora.register_interactions()
        iop.seal_interaction_registrations()
        aurora.register_queries()
        iop.seal_query_registrations()
    aurora.produce_proof(primary, auxiliary)
    return iop.get_transcript()


def aurora_snark_verifier(r1cs, primary: List[int], transcript: BCSTranscript,
                          params: AuroraSnarkParams, device="cuda") -> bool:
    dev = resolve_device(device)
    F = r1cs.F
    iop = BCSVerifier(F, params.bcs_params(), transcript, dev)
    with PROFILER.block("verifier_registration"):
        aurora = AuroraIOP(iop, r1cs, params.iop_params(
            F, r1cs.num_constraints, r1cs.num_variables))
        aurora.register_interactions()
        iop.seal_interaction_registrations()
        aurora.register_queries()
        iop.seal_query_registrations()
    with PROFILER.block("verifier_transcript_valid"):
        if not iop.transcript_is_valid():
            return False
        iop.finalize_query_positions()
    try:
        with PROFILER.block("verifier_predicate"):
            return aurora.verifier_predicate(primary)
    except BCSVerificationError:
        return False
