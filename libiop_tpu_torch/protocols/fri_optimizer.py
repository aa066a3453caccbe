"""FRI localization-parameter optimizer: brute-force search over localization
vectors minimizing predicted BCS argument size (port of
libiop_tpu/protocols/fri_optimizer.py; host math only).

Counterpart of libiop/protocols/ldt/fri/argument_size_optimizer.{hpp,tcc}
(used by the instrument CLIs with --optimize_localization=1,
instrument_aurora_snark.cpp:124-148): for each candidate vector [1, e2, e3..]
with sum <= codeword_dim - RS_extra, predict

  argument size ~= sum over FRI rounds of
      (revealed leaf bytes) + (expected pruned Merkle path digests)
  + final polynomial bytes + BCS digests/pow overhead

using the expected-pruned-path count for q random leaves of a depth-d tree
(merkle_tree count_hashes_to_verify model), and pick the arg-min.
"""
from __future__ import annotations

import math
from typing import List, Tuple

from .fri import FRIParameters, FRISoundnessType


def expected_pruned_path_digests(depth: int, num_queries: int) -> float:
    """Expected number of auxiliary digests in a pruned multi-proof for
    num_queries uniform leaves of a 2^depth-leaf tree: at level l (from the
    leaves) there are 2^(depth-l) nodes; each *sibling* of a known node is
    revealed unless it is itself derivable.  E[digests at level l] ~=
    E[#known nodes at level l+... ] — we use the standard approximation
    E[#revealed] = sum_l E[#nodes needed at level l] - E[#nodes at l+1]."""
    total = 0.0
    m = num_queries
    nodes = 2.0 ** depth
    expected_known = m - m * (m - 1) / (2 * nodes)  # distinct leaves approx
    prev = max(1.0, expected_known)
    for _ in range(depth):
        nodes /= 2
        if nodes <= 1:
            nxt = 1.0
        else:
            # E[#occupied parents] for prev known children over `nodes` slots
            nxt = nodes * -math.expm1(prev * math.log1p(-1.0 / nodes))
            nxt = min(nxt, nodes, prev)
        # siblings needed = 2*nxt - prev (each parent needs both children)
        total += max(0.0, 2 * nxt - prev)
        prev = nxt
    return total


def predict_argument_size(F, params: FRIParameters,
                          num_input_oracles: int, digest_bytes: int) -> float:
    """Predicted transcript bytes for the FRI phase + final polys."""
    eb = F.elem_bytes
    q = params.num_query_repetitions
    ni = params.num_interactive_repetitions
    dim = params.codeword_domain_dim
    total = 0.0
    # round 0: input oracles over codeword domain, coset size 2^eta0
    etas = params.localization_parameters
    cur_dim = dim
    for i, eta in enumerate(etas):
        leaves_dim = cur_dim - eta
        oracles = num_input_oracles if i == 0 else ni
        coset = 1 << eta
        # revealed leaf bytes: q distinct leaves x oracles x coset elements
        total += q * oracles * coset * eb
        total += expected_pruned_path_digests(leaves_dim, q) * digest_bytes
        cur_dim -= eta
    final_deg = params.poly_degree_bound >> sum(etas)
    total += ni * max(1, final_deg) * eb
    return total


def optimize_localization_parameters(
        F, security_parameter: int, tested_degree_bound: int,
        codeword_domain_dim: int, RS_extra_dimensions: int,
        absolute_proximity_parameter: int,
        num_input_oracles: int, digest_bytes: int = 32,
        soundness_type: str = FRISoundnessType.heuristic,
        max_eta: int = 4) -> Tuple[List[int], float]:
    """Search localization vectors [1, e, e, ...] and general non-uniform
    tails, returning (best_vector, predicted_bytes).
    (argument_size_optimizer.hpp:21-52 role.)"""
    budget = codeword_domain_dim - RS_extra_dimensions - 1
    best = None
    best_size = math.inf
    # enumerate vectors: first entry 1, then up to `budget` entries in 1..max_eta
    def candidates():
        seen = set()
        for eta in range(1, max_eta + 1):
            rest = budget - 1
            vec = [1] + [eta] * (rest // eta)
            key = tuple(vec)
            if key not in seen and sum(vec) <= budget + 1:
                seen.add(key)
                yield vec
        # non-uniform two-level tails
        for e1 in range(1, max_eta + 1):
            for e2 in range(1, max_eta + 1):
                n1 = (budget - 1) // (2 * e1)
                n2 = max(0, (budget - 1 - n1 * e1) // e2)
                vec = [1] + [e1] * n1 + [e2] * n2
                key = tuple(vec)
                if vec and key not in seen and sum(vec) <= budget + 1:
                    seen.add(key)
                    yield vec

    for vec in candidates():
        rounded = FRIParameters.next_testable_degree_bound(
            tested_degree_bound, vec)
        if rounded > 1 << (codeword_domain_dim - RS_extra_dimensions):
            continue
        try:
            params = FRIParameters(
                F, security_parameter + 3, security_parameter + 1,
                soundness_type, rounded, codeword_domain_dim,
                RS_extra_dimensions, absolute_proximity_parameter, vec)
        except (ValueError, ZeroDivisionError):
            continue
        size = predict_argument_size(F, params, num_input_oracles, digest_bytes)
        if size < best_size:
            best_size = size
            best = vec
    assert best is not None, "no feasible localization vector"
    return best, best_size


# ---------------------------------------------------------------------------
# circuit-size optimizer (circuit_size_optimizer.{hpp,tcc} role): pick the
# localization vector minimizing the size of a RECURSIVE VERIFIER circuit
# (R1CS constraints), not the transcript bytes.
# ---------------------------------------------------------------------------
class HashCircuitDescription:
    """Constraint-cost model of the hash inside a circuit
    (hashing.hpp:72-82 hash_circuit_description role).  Defaults approximate
    an algebraic (Poseidon-style) hash: cost scales with the number of
    sponge-rate-sized absorptions."""

    def __init__(self, arity_2_cost: int = 300, per_element_cost: int = 150,
                 chain_cost: int = 300):
        self.arity_2_cost = arity_2_cost
        self.per_element_cost = per_element_cost
        self.chain_cost = chain_cost

    def arity_m_hash_complexity(self, m: int) -> int:
        return self.arity_2_cost + max(0, m - 2) * self.per_element_cost

    def hash_chain_complexity(self, sponge_state_size: int,
                              input_size: int) -> int:
        return self.chain_cost * max(1, input_size)


def predict_circuit_size(oracle_locality_vector: List[int],
                         fri_localization_vector: List[int],
                         codeword_dim: int, num_queries: int,
                         max_tested_degree: int,
                         encoded_circuit_cost_per_query: int,
                         hash_info: HashCircuitDescription) -> int:
    """Predicted verifier-circuit constraint count (circuit_size_optimizer
    .tcc:1-170 model): per-round coset interpolations + final Lagrange
    interpolation + Merkle leaf/path hashes with an upper-cap shared across
    queries + per-round hashchain absorptions."""
    etas = list(fri_localization_vector)
    # IOP side: encoded protocol queries + per-round interpolation + final
    encoded = encoded_circuit_cost_per_query * (1 << etas[0]) * num_queries
    round_costs = 0
    for eta in etas:
        round_costs += (1 << eta) * 2 + eta * 2 + 4
    round_costs = round_costs * num_queries + 4 * len(etas)
    final_deg = max(1, max_tested_degree >> sum(etas))
    final_interp = (final_deg + 1) * num_queries
    iop_cost = encoded + round_costs + final_interp
    # BCS side: leaf hashes
    leaf_cost = 0
    for locality in oracle_locality_vector:
        leaf_cost += hash_info.arity_m_hash_complexity(
            locality * (1 << etas[0]))
    for eta in etas[1:]:
        leaf_cost += hash_info.arity_m_hash_complexity(1 << eta)
    leaf_cost *= num_queries
    # BCS side: 2-to-1 path hashes with a shared upper cap of depth
    # ~log2(num_queries): the top of each tree is hashed once, lower layers
    # once per query (no collision modeling)
    cap = max(0, num_queries.bit_length() - 2)
    two_to_one = 0
    cap_cost = 0
    cur_dim = codeword_dim - etas[0]
    two_to_one += max(0, cur_dim - cap) * num_queries * len(oracle_locality_vector)
    cap_cost += len(oracle_locality_vector) * \
        hash_info.arity_m_hash_complexity(1 << min(cap, cur_dim))
    for eta in etas[1:]:
        cur_dim -= eta
        depth = max(0, cur_dim)
        cur_cap = min(cap, depth)
        two_to_one += max(0, depth - cur_cap) * num_queries
        cap_cost += hash_info.arity_m_hash_complexity(1 << cur_cap)
    path_cost = two_to_one * (hash_info.arity_m_hash_complexity(2) + 2) + cap_cost
    chain_cost = hash_info.hash_chain_complexity(2, 1) * len(etas)
    return iop_cost + leaf_cost + path_cost + chain_cost


def optimize_localization_for_circuit_size(
        oracle_locality_vector: List[int], codeword_dim: int,
        num_queries: int, max_tested_degree: int,
        encoded_circuit_cost_per_query: int = 100,
        hash_info: HashCircuitDescription | None = None,
        max_eta: int = 4) -> Tuple[List[int], int]:
    """Brute-force all localization vectors (first entry fixed to 1,
    circuit_size_optimizer.tcc:190-205) and return the arg-min with its
    predicted constraint count."""
    hash_info = hash_info or HashCircuitDescription()
    budget = max(1, (max_tested_degree.bit_length() - 1) - 1 - 2)

    def compositions(n):
        if n == 0:
            yield []
            return
        for first in range(1, min(max_eta, n) + 1):
            for rest in compositions(n - first):
                yield [first] + rest

    best, best_size = None, None
    for tail in compositions(budget - 1):
        vec = [1] + tail
        size = predict_circuit_size(
            oracle_locality_vector, vec, codeword_dim, num_queries,
            max_tested_degree, encoded_circuit_cost_per_query, hash_info)
        if best_size is None or size < best_size:
            best, best_size = vec, size
    return best, best_size
