"""Fractal SNARK: indexer, prover and verifier (port of
libiop_tpu/snark/fractal.py).

The indexer runs the holographic round 0 once and returns the prover index
(the index oracles, their K-vectors and Merkle trees) and the verifier
index (the round-0 Merkle roots).  The prover proves from the prover index
without hashing round 0; the verifier writes its own index roots into the
transcript before it replays it, so a prover cannot substitute its own
matrices.  Every entry point takes the reference's arguments plus
``device=`` (default "cuda"; "cpu" runs the plain PyTorch path).  The
index roots and proof bytes are the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..bcs.common import BCSParameters, BCSTranscript
from ..bcs.prover import BCSProver
from ..bcs.verifier import BCSVerificationError, BCSVerifier
from ..device import resolve_device
from ..protocols.fractal import FractalIOP, FractalIOPParams
from ..protocols.fri import FRISoundnessType
from ..protocols.ldt_reducer import LDTReducerSoundnessType
from ..utils.profiling import PROFILER


@dataclasses.dataclass
class FractalSnarkParams:
    security_parameter: int = 128
    RS_extra_dimensions: int = 3
    fri_localization_parameter: int = 2
    make_zk: bool = False
    hash_name: str = "blake2b"
    pow_bits: int = 0
    fri_soundness_type: str = FRISoundnessType.heuristic
    ldt_reducer_soundness_type: str = LDTReducerSoundnessType.optimistic_heuristic
    override_fri_queries: Optional[int] = None
    override_fri_interactive_repetitions: Optional[int] = None
    override_ldt_instances: Optional[int] = None
    override_lincheck_repetitions: Optional[int] = None

    def iop_params(self, F, r1cs) -> FractalIOPParams:
        p = FractalIOPParams(
            F, self.security_parameter, self.pow_bits,
            self.RS_extra_dimensions, self.make_zk, r1cs,
            self.fri_localization_parameter, self.fri_soundness_type,
            self.ldt_reducer_soundness_type)
        if self.override_fri_queries is not None:
            p.fri_params.num_query_repetitions = self.override_fri_queries
        if self.override_fri_interactive_repetitions is not None:
            p.fri_params.num_interactive_repetitions = \
                self.override_fri_interactive_repetitions
        if self.override_ldt_instances is not None:
            p.ldt_reducer_params.num_output_LDT_instances = \
                self.override_ldt_instances
        if self.override_lincheck_repetitions is not None:
            p.encoded_params.holographic_lincheck_params.num_repetitions = \
                self.override_lincheck_repetitions
        return p

    def bcs_params(self) -> BCSParameters:
        return BCSParameters(security_bits=self.security_parameter,
                             hash_name=self.hash_name, pow_bits=self.pow_bits)


def _setup(r1cs, params: FractalSnarkParams, engine,
           rng: Optional[np.random.Generator] = None) -> FractalIOP:
    fr = FractalIOP(engine, r1cs, params.iop_params(r1cs.F, r1cs), rng=rng)
    fr.register_interactions()
    engine.seal_interaction_registrations()
    fr.register_queries()
    engine.seal_query_registrations()
    return fr


def fractal_snark_indexer(r1cs, params: FractalSnarkParams,
                          rng: Optional[np.random.Generator] = None,
                          device="cuda"):
    """Returns (prover_index, verifier_index)."""
    dev = resolve_device(device)
    iop = BCSProver(r1cs.F, params.bcs_params(), dev)
    with PROFILER.block("registration"):
        fr = _setup(r1cs, params, iop, rng)
    with PROFILER.block("index"):
        fr.produce_index()
    verifier_index = {k: v for k, v in iop.mt_roots.items() if k[0] == 0}
    return fr.get_index_artifact(), verifier_index


def fractal_snark_prover(r1cs, primary: List[int], auxiliary: List[int],
                         prover_index, params: FractalSnarkParams,
                         rng: Optional[np.random.Generator] = None,
                         device="cuda") -> BCSTranscript:
    """Prove from an indexer's prover index.  With ``params.make_zk`` the
    masking polynomials draw from ``rng`` and the Merkle salts from
    ``secrets.token_bytes``, as the reference's."""
    dev = resolve_device(device)
    iop = BCSProver(r1cs.F, params.bcs_params(), dev)
    with PROFILER.block("registration"):
        fr = _setup(r1cs, params, iop, rng)
    fr.submit_index(prover_index)
    fr.produce_proof(primary, auxiliary)
    return iop.get_transcript()


def fractal_snark_verifier(r1cs, primary: List[int],
                           verifier_index: Dict[Tuple[int, int], bytes],
                           transcript: BCSTranscript,
                           params: FractalSnarkParams, device="cuda") -> bool:
    """The verifier trusts only its own index roots for round 0: they
    overwrite the transcript's before the replay."""
    dev = resolve_device(device)
    for k, root in verifier_index.items():
        transcript.mt_roots[k] = root
    iop = BCSVerifier(r1cs.F, params.bcs_params(), transcript, dev)
    with PROFILER.block("verifier_registration"):
        fr = _setup(r1cs, params, iop)
    with PROFILER.block("verifier_transcript_valid"):
        if not iop.transcript_is_valid():
            return False
        iop.finalize_query_positions()
    try:
        with PROFILER.block("verifier_predicate"):
            return fr.verifier_predicate(primary)
    except BCSVerificationError:
        return False
