"""Hand the same state to both packages: numpy arrays and Python ints only.

``limbs_from_numpy`` / ``limbs_to_numpy`` convert between the reference's
(L, *batch) uint32 arrays (16-bit limbs of a prime field, L = 12 or 16, or
32-bit words of a binary field, L = W) and the port's int32 tensors (same
bits, same layout); ``r1cs_from_reference`` rebuilds a constraint system
over a given field from the reference's ``R1CS.constraints`` int triples;
``fractal_index_from_reference`` turns the reference's Fractal prover index
into the port's; ``domain_from_reference`` and
``fri_parameters_from_reference`` rebuild a domain and an FRIParameters
over the port's field from the reference's ints.
"""
from __future__ import annotations

import numpy as np
import torch

from .algebra.domains import MultiplicativeCoset
from .algebra.subspace import AffineSubspace
from .bcs.common import DeviceLeafBlocks
from .protocols.fri import FRIParameters
from .relations.r1cs import R1CS


def limbs_from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr, dtype=np.uint32).astype(np.int32))).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def r1cs_from_reference(F, num_inputs: int, num_variables: int,
                        constraints) -> R1CS:
    """The port's R1CS over the port's field F with the reference's
    constraint triples [(A pairs, B pairs, C pairs), ...]."""
    cs = R1CS(F, num_inputs, num_variables)
    for A, B, C in constraints:
        cs.add_constraint([(int(i), int(c)) for i, c in A],
                          [(int(i), int(c)) for i, c in B],
                          [(int(i), int(c)) for i, c in C])
    return cs


def _digest_heap(nodes) -> torch.Tensor:
    """A BLAKE2b node list in heap layout (nodes[1] the root, nodes[n:] the
    leaf digests) as the port's (2n, dw) heap of digest words."""
    dw = len(nodes[1]) // 4
    blob = b"\0" * (4 * dw) + b"".join(nodes[1:])
    return limbs_from_numpy(np.frombuffer(blob, "<u4").reshape(-1, dw))


def fractal_index_from_reference(F, artifact, device="cpu"):
    """The port's Fractal prover index from the reference's
    ``fractal_snark_indexer`` prover index (evaluations of the round-0
    oracles, the K-vectors, and per round-0 tree its leaf blocks and node
    digests; the device-built BLAKE2b trees' word rows), over a prime field
    (limbs) or GF(2^k) (words), so the port proves from an index the
    reference made."""
    evals_map, vectors, mt_data = artifact
    evals = {int(oid): limbs_from_numpy(np.asarray(ev), device)
             for oid, ev in evals_map.items()}
    vecs = [[limbs_from_numpy(np.asarray(v), device) for v in per_matrix]
            for per_matrix in vectors]
    trees = {tuple(key): (DeviceLeafBlocks(limbs_from_numpy(
        np.asarray(blocks.words), device), blocks.block_len),
        _digest_heap(nodes).to(device))
        for key, (blocks, nodes) in mt_data.items()}
    return evals, vecs, trees


def domain_from_reference(F, domain):
    """The port's domain over F with the reference domain's ints: a
    multiplicative coset (dim, shift, generator) or an affine subspace
    (dim, shift, basis)."""
    if domain.kind == "affine_subspace":
        return AffineSubspace(F, domain.dim, int(domain.shift),
                              [int(b) for b in domain.basis])
    return MultiplicativeCoset(F, domain.dim, int(domain.shift),
                               int(domain.g))


def fri_parameters_from_reference(F, params) -> FRIParameters:
    """The port's FRIParameters over F with the reference parameters'
    degree bound, dimensions, localization vector and repetition counts
    (the counts as the reference holds them, overrides included)."""
    out = FRIParameters.__new__(FRIParameters)
    out.F = F
    for name in ("soundness_type", "poly_degree_bound", "codeword_domain_dim",
                 "RS_extra_dimensions", "effective_proximity",
                 "num_query_repetitions", "num_interactive_repetitions"):
        setattr(out, name, getattr(params, name))
    out.localization_parameters = list(params.localization_parameters)
    return out
