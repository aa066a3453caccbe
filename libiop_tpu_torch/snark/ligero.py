"""Ligero SNARK: the BCS-compiled non-interactive argument (port of
libiop_tpu/snark/ligero.py; BLAKE2b, zk or not).

``ligero_snark_prover`` / ``ligero_snark_verifier`` take the reference's
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
from ..protocols.ldt_reducer import LDTReducerSoundnessType
from ..protocols.ligero import LigeroIOP, LigeroIOPParams
from ..utils.profiling import PROFILER


@dataclasses.dataclass
class LigeroSnarkParams:
    security_parameter: int = 128
    RS_extra_dimensions: int = 3
    height_width_ratio: float = 1.0
    make_zk: bool = False
    hash_name: str = "blake2b"
    pow_bits: int = 0
    ldt_reducer_soundness_type: str = LDTReducerSoundnessType.optimistic_heuristic
    override_num_interactions: Optional[int] = None
    override_num_queries: Optional[int] = None
    override_ldt_instances: Optional[int] = None

    def iop_params(self, F, r1cs) -> LigeroIOPParams:
        p = LigeroIOPParams(
            F, self.security_parameter, self.RS_extra_dimensions,
            self.height_width_ratio, self.make_zk, r1cs.num_constraints,
            r1cs.num_variables, self.ldt_reducer_soundness_type)
        if self.override_num_interactions is not None:
            p.encoded_params.num_interactions = self.override_num_interactions
        if self.override_num_queries is not None:
            p.encoded_params.num_queries = self.override_num_queries
            p.direct_ldt_params.num_queries = self.override_num_queries
        if self.override_ldt_instances is not None:
            p.ldt_reducer_params.num_output_LDT_instances = \
                self.override_ldt_instances
        return p

    def bcs_params(self) -> BCSParameters:
        return BCSParameters(security_bits=self.security_parameter,
                             hash_name=self.hash_name, pow_bits=self.pow_bits)


def ligero_snark_prover(r1cs, primary: List[int], auxiliary: List[int],
                        params: LigeroSnarkParams,
                        rng: Optional[np.random.Generator] = None,
                        device="cuda") -> BCSTranscript:
    """Prove r1cs satisfiability.  With ``params.make_zk`` the blinding rows
    and the LDT's masking polynomial draw from ``rng`` (a fresh unseeded
    generator when None) and the Merkle salts from ``secrets.token_bytes``,
    as the reference's."""
    dev = resolve_device(device)
    F = r1cs.F
    iop = BCSProver(F, params.bcs_params(), dev)
    with PROFILER.block("registration"):
        lig = LigeroIOP(iop, r1cs, params.iop_params(F, r1cs), rng=rng)
        lig.register_interactions()
        iop.seal_interaction_registrations()
        lig.register_queries()
        iop.seal_query_registrations()
    lig.produce_proof(primary, auxiliary)
    return iop.get_transcript()


def ligero_snark_verifier(r1cs, primary: List[int], transcript: BCSTranscript,
                          params: LigeroSnarkParams, device="cuda") -> bool:
    dev = resolve_device(device)
    F = r1cs.F
    iop = BCSVerifier(F, params.bcs_params(), transcript, dev)
    with PROFILER.block("verifier_registration"):
        lig = LigeroIOP(iop, r1cs, params.iop_params(F, r1cs))
        lig.register_interactions()
        iop.seal_interaction_registrations()
        lig.register_queries()
        iop.seal_query_registrations()
    with PROFILER.block("verifier_transcript_valid"):
        if not iop.transcript_is_valid():
            return False
        iop.finalize_query_positions()
    try:
        with PROFILER.block("verifier_predicate"):
            return lig.verifier_predicate(primary)
    except BCSVerificationError:
        return False
