"""Hand the same state to both packages: numpy arrays and Python ints only.

``limbs_from_numpy`` / ``limbs_to_numpy`` convert between the reference's
(L, *batch) uint32 arrays (16-bit limbs of a prime field, L = 12 or 16, or
32-bit words of a binary field, L = W) and the port's int32 tensors (same
bits, same layout); ``r1cs_from_reference`` rebuilds a constraint system
over a given field from the reference's ``R1CS.constraints`` int triples.
"""
from __future__ import annotations

import numpy as np
import torch

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
