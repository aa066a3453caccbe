"""FRI low-degree test over both domain families (port of
libiop_tpu/protocols/fri.py).

Domain chain L^(i+1) = q(L^(i)): over multiplicative cosets q(x) =
x^{2^eta_i} and cosets are strided {j, j + N/c, ...}; over affine subspaces
q is the linearized vanishing polynomial Z_V of the localizer subspace V
(the first eta_i basis vectors), the next basis and shift are the images
of the remaining basis vectors and of the shift, and cosets are contiguous
[j c, (j+1) c).  The prover folds every round at the verifier challenge
(kernel K4, or K19 over a subspace) and sends the final polynomial; the
verifier chases one query through the rounds with host-int coset
interpolation.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..algebra.domains import MultiplicativeCoset, device_table
from ..algebra.generic import ifft_known_any, is_additive
from ..algebra.linearized import LinearizedVanishing
from ..algebra.subspace import AffineSubspace, subset_sums_ints
from ..fields.binary import subset_sums
from ..iop.runtime import IOPProtocol, OracleHandle, RoundParameters
from ..kernels.fri_fold import fri_fold
from ..kernels.fri_fold_additive import fri_fold_additive
from ..kernels.powers import powers
from ..utils.profiling import PROFILER


def log2_field_size(F) -> float:
    """Soundness log2|F| (libff soundness_log_of_field_size_helper role)."""
    if F.kind == "additive":
        return float(F.k)
    b = F.p.bit_length()
    return math.log2(F.p >> max(0, b - 53)) + max(0, b - 53)


class FRISoundnessType:
    proven = "proven"
    heuristic = "heuristic"


class FRIParameters:
    """Repetition counts from the FRI soundness analysis (fri_ldt.tcc:1-254)."""

    def __init__(self, F, interactive_soundness_bits: int,
                 query_soundness_bits: int, soundness_type: str,
                 poly_degree_bound: int, codeword_domain_dim: int,
                 RS_extra_dimensions: int, absolute_proximity_parameter: int,
                 localization_parameters: List[int]):
        self.F = F
        self.soundness_type = soundness_type
        self.poly_degree_bound = poly_degree_bound
        self.codeword_domain_dim = codeword_domain_dim
        self.RS_extra_dimensions = RS_extra_dimensions
        self.localization_parameters = list(localization_parameters)
        if poly_degree_bound % (1 << sum(self.localization_parameters)) != 0:
            raise ValueError("FRI degree bound must be a multiple of "
                             "2^{sum of localization parameters}")
        rate = 2.0 ** (-RS_extra_dimensions)
        codeword_domain_size = 2.0 ** codeword_domain_dim
        frac_prox = absolute_proximity_parameter / codeword_domain_size
        field_bits = log2_field_size(F)
        loc_coset_size = 2.0 ** self.localization_parameters[0]
        if soundness_type == FRISoundnessType.proven:
            term2 = (1 - 3 * rate
                     - loc_coset_size / math.sqrt(codeword_domain_size)) / 4
            self.effective_proximity = min(frac_prox, term2)
            per_interaction = math.log2(3) + codeword_domain_dim - field_bits
        else:
            self.effective_proximity = frac_prox
            per_interaction = math.log2(loc_coset_size - 1.0) - field_bits
        denom = math.log2(1 - self.effective_proximity)
        self.num_query_repetitions = max(
            1, int(math.ceil(-query_soundness_bits / denom)))
        self.num_interactive_repetitions = max(
            1, int(math.ceil(-interactive_soundness_bits / per_interaction)))

    @staticmethod
    def localization_parameter_to_array(localization_parameter: int,
                                        codeword_domain_dim: int,
                                        RS_extra_dimensions: int) -> List[int]:
        """[1, eta, eta, ...] (the first round always folds by 2)."""
        num_reductions = max(1, (codeword_domain_dim - RS_extra_dimensions - 1)
                             // localization_parameter)
        return [1] + [localization_parameter] * (num_reductions - 1) \
            if localization_parameter > 0 else [1]

    @staticmethod
    def next_testable_degree_bound(degree: int,
                                   localization_parameters: List[int]) -> int:
        m = 1 << sum(localization_parameters)
        return -(-degree // m) * m


def _fold_rows(F, eta: int) -> np.ndarray:
    """(L, c*c) inverse mini-NTT table: rows[t*c + k] = (1/c) g^{-tk}."""
    c = 1 << eta
    p = F.p
    g_inv = pow(pow(F.root_of_unity, 1 << (F.two_adicity - eta), p), p - 2, p)
    c_inv = pow(c, p - 2, p)
    return np.ascontiguousarray(F.from_ints_np(
        [pow(g_inv, (t * k) % c, p) * c_inv % p
         for t in range(c) for k in range(c)]), dtype=np.int32)


def fold_codeword(F, evals: torch.Tensor, domain: MultiplicativeCoset,
                  eta: int, x_int: int) -> torch.Tensor:
    """One FRI reduction of a natural-order codeword: (L, N) -> (L, N/2^eta)
    over q(domain).  Restricted to coset {h_j g^k}, f = p_j(u) with
    intra-coset inverse-NTT coefficients, and the folded value is p_j(x/h_j)."""
    dev = evals.device
    c = 1 << eta
    rows = device_table(("fri_rows", F.name, eta), dev,
                        lambda: _fold_rows(F, eta))
    x_over_shift = F.from_ints([x_int * pow(domain.shift, F.p - 2, F.p) % F.p],
                               dev).reshape(F.L)
    xpow = powers(F, x_over_shift, c)
    return fri_fold(F, evals.contiguous(), rows,
                    domain.inverse_generator_powers(dev), xpow, c)


def interpolate_coset_at_point_ints(F, coset_values: List[int],
                                    coset_shift: int, eta: int, x: int) -> int:
    """Host-int mirror of one coset's fold (verifier side)."""
    c = 1 << eta
    p = F.p
    g = pow(F.root_of_unity, 1 << (F.two_adicity - eta), p)
    gpows = [pow(g, i, p) for i in range(c)]
    c_inv = pow(c, p - 2, p)
    x_over_h = x * pow(coset_shift, p - 2, p) % p
    total = 0
    xt = 1
    for t in range(c):
        a_t = sum(coset_values[k] * gpows[(-t * k) % c]
                  for k in range(c)) * c_inv % p
        total = (total + a_t * xt) % p
        xt = xt * x_over_h % p
    return total


def localizer_vanishing(domain: AffineSubspace, eta: int
                        ) -> LinearizedVanishing:
    """Z of the unshifted localizer subspace span(basis[:eta])."""
    return LinearizedVanishing(AffineSubspace(
        domain.field, eta, shift=0, basis=domain.basis[:eta]))


def coset_vanishing_offsets(domain: AffineSubspace, eta: int,
                            Z: LinearizedVanishing, device) -> torch.Tensor:
    """(W, N/c) Z_V at each coset's shift, in coset order (constant on the
    coset by F2-linearity): subset sums of Z_V over the remaining basis
    vectors, memoized per device."""
    F = domain.field

    def compute():
        z_rest = [Z._eval_linear(Z.linear_coeffs, b)
                  for b in domain.basis[eta:]]
        return subset_sums(
            F.from_ints(z_rest, device).reshape(F.W, len(z_rest)),
            F.from_ints([Z.eval_at_point_int(domain.shift)], device))

    return device_table(("fri_offsets", domain._key(), eta), device, compute)


def fold_codeword_additive(F, evals: torch.Tensor, domain: AffineSubspace,
                           eta: int, x_int: int) -> torch.Tensor:
    """One additive FRI reduction (W, N) -> (W, N/2^eta): per contiguous
    coset the Lagrange interpolation at x, eps^-1 Z_{C_j}(x) sum_e
    f(e)/(x - e), or f(e) where x = e (kernel K19 on the card)."""
    Z = localizer_vanishing(domain, eta)
    dev = evals.device
    return fri_fold_additive(
        F, evals.contiguous(), domain.elements(dev),
        coset_vanishing_offsets(domain, eta, Z, dev), x_int,
        Z.eval_at_point_int(x_int), F.inv_int(Z.epsilon), 1 << eta)


def interpolate_coset_additive_ints(F, coset_values: List[int],
                                    coset_shift: int, Z: LinearizedVanishing,
                                    basis: List[int], x: int) -> int:
    """Host-int mirror of one additive coset's fold (verifier side); basis
    is the localizer subspace's (the round domain's first eta vectors)."""
    elems = subset_sums_ints(F, basis, coset_shift)
    for k, e in enumerate(elems):
        if e == x:
            return coset_values[k]
    z_x = Z.eval_at_point_int(x) ^ Z.eval_at_point_int(coset_shift)
    scale = F.mul_ints(F.inv_int(Z.epsilon), z_x)
    total = 0
    for k, v in enumerate(coset_values):
        total ^= F.mul_ints(v, F.inv_int(x ^ elems[k]))
    return F.mul_ints(scale, total)


class FRIProtocol:
    """Multi-FRI: several codewords share challenges and query positions."""

    def __init__(self, iop: IOPProtocol, params: FRIParameters,
                 codeword_handle, poly_handles: List[OracleHandle]):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.codeword_handle = codeword_handle
        self.poly_handles = list(poly_handles)
        self.num_reductions = len(params.localization_parameters)
        dom0 = iop.get_domain(codeword_handle)
        self.additive = is_additive(dom0)
        self.domains = [dom0]
        self.localizers: List[LinearizedVanishing] = []
        if self.additive:
            dom = dom0
            for eta in params.localization_parameters:
                Z = localizer_vanishing(dom, eta)
                self.localizers.append(Z)
                dom = AffineSubspace(
                    self.F, dom.dim - eta, shift=Z.eval_at_point_int(dom.shift),
                    basis=[Z._eval_linear(Z.linear_coeffs, b)
                           for b in dom.basis[eta:]])
                self.domains.append(dom)
            return
        shift, dim = dom0.shift, dom0.dim
        for eta in params.localization_parameters:
            shift = pow(shift, 1 << eta, self.F.p)
            dim -= eta
            self.domains.append(MultiplicativeCoset(self.F, dim, shift))

    def register_interactions(self):
        ni = self.params.num_interactive_repetitions
        etas = self.params.localization_parameters
        self.domain_handles = [self.codeword_handle]
        self.oracle_handles: List[List[List[OracleHandle]]] = [
            [list(self.poly_handles)]]
        self.challenge_handles = [
            [self.iop.register_verifier_random_message(1) for _ in range(ni)]]
        for i in range(1, self.num_reductions):
            degree_bound = self.params.poly_degree_bound >> sum(etas[:i])
            dh = self.iop.register_domain(self.domains[i])
            per_interaction = [[self.iop.register_oracle(dh, degree_bound)
                                for _ in self.poly_handles] for _ in range(ni)]
            self.iop.set_round_parameters(RoundParameters(
                quotient_map_size=1 << etas[i]))
            self.domain_handles.append(dh)
            self.oracle_handles.append(per_interaction)
            self.challenge_handles.append(
                [self.iop.register_verifier_random_message(1) for _ in range(ni)])
        self.final_degree_bound = self.params.poly_degree_bound >> sum(etas)
        self.final_poly_handles = [
            [self.iop.register_prover_message(max(1, self.final_degree_bound))
             for _ in self.poly_handles] for _ in range(ni)]

    def register_queries(self):
        etas = self.params.localization_parameters
        self.query_sets = []
        for _ in range(self.params.num_query_repetitions):
            s0 = self.iop.register_random_query_position(self.domain_handles[0])
            coset_handles = []
            s_handle = s0
            for i in range(self.num_reductions):
                dom = self.domains[i]
                c = 1 << etas[i]
                coset_handles.append([
                    self.iop.register_deterministic_query_position(
                        [s_handle],
                        (lambda s, k=k, dom=dom, c=c: dom.position_by_coset_indices(
                            dom.coset_index(s, c), k, c)))
                    for k in range(c)])
                s_handle = self.iop.register_deterministic_query_position(
                    [s_handle], (lambda s, dom=dom, c=c: dom.coset_index(s, c)))
            for j in range(self.params.num_interactive_repetitions):
                for ldt in range(len(self.poly_handles)):
                    qset = {"s0": s0, "interaction": j, "ldt": ldt,
                            "coset_queries": []}
                    for i in range(self.num_reductions):
                        ji = 0 if i == 0 else j
                        qset["coset_queries"].append([
                            self.iop.register_query(
                                self.oracle_handles[i][ji][ldt], ph)
                            for ph in coset_handles[i]])
                    self.query_sets.append(qset)

    def calculate_and_submit_proof(self):
        F = self.F
        ni = self.params.num_interactive_repetitions
        etas = self.params.localization_parameters
        with PROFILER.block("fri_combine_inputs"):
            base_evals = self.iop.get_fused_oracle_evaluations(self.poly_handles)
        per_interaction = [list(base_evals) for _ in range(ni)]
        fold = fold_codeword_additive if self.additive else fold_codeword
        for i in range(self.num_reductions):
            if i > 0:
                with PROFILER.block(f"fri_round{i}_commit"):
                    for j in range(ni):
                        for ldt, ev in enumerate(per_interaction[j]):
                            self.iop.submit_oracle(
                                self.oracle_handles[i][j][ldt], ev)
                    self.iop.signal_prover_round_done()
            with PROFILER.block(f"fri_round{i}_fold"):
                for j in range(ni):
                    x_i = self.iop.obtain_verifier_random_message(
                        self.challenge_handles[i][j])[0]
                    per_interaction[j] = [
                        fold(F, ev, self.domains[i], etas[i], x_i)
                        for ev in per_interaction[j]]
        final_domain = self.domains[self.num_reductions]
        with PROFILER.block("fri_final_poly"):
            for j in range(ni):
                for ldt, ev in enumerate(per_interaction[j]):
                    coeffs = ifft_known_any(ev, final_domain, final_domain.order)
                    ints = [int(v) for v in F.to_ints(
                        coeffs[:, :max(1, self.final_degree_bound)])]
                    self.iop.submit_prover_message(
                        self.final_poly_handles[j][ldt], ints)
        with PROFILER.block("fri_final_commit"):
            self.iop.signal_prover_round_done()

    def verifier_predicate(self) -> bool:
        ok = True
        with PROFILER.block("fri_verifier_queries"):
            for qset in self.query_sets:
                if not self._predicate_for_query_set(qset):
                    ok = False
        return ok

    def _predicate_for_query_set(self, qset) -> bool:
        F = self.F
        etas = self.params.localization_parameters
        s_idx = self.iop.obtain_query_position(qset["s0"])
        s = self.domains[0].element_by_index_int(s_idx)
        last_interp = None
        for i in range(self.num_reductions):
            x_i = self.iop.obtain_verifier_random_message(
                self.challenge_handles[i][qset["interaction"]])[0]
            c = 1 << etas[i]
            dom = self.domains[i]
            si_j = dom.coset_index(s_idx, c)
            si_k = dom.intra_coset_index(s_idx, c)
            coset_vals = [self.iop.obtain_query_response(qh)
                          for qh in qset["coset_queries"][i]]
            if i > 0 and last_interp != coset_vals[si_k]:
                return False
            coset_shift = dom.element_by_index_int(
                dom.position_by_coset_indices(si_j, 0, c))
            if self.additive:
                last_interp = interpolate_coset_additive_ints(
                    F, coset_vals, coset_shift, self.localizers[i],
                    dom.basis[:etas[i]], x_i)
                s = self.localizers[i].eval_at_point_int(s)
            else:
                last_interp = interpolate_coset_at_point_ints(
                    F, coset_vals, coset_shift, etas[i], x_i)
                s = F.pow_int(s, 1 << etas[i])
            s_idx = si_j
        final_coeffs = self.iop.receive_prover_message(
            self.final_poly_handles[qset["interaction"]][qset["ldt"]])
        val = 0
        for cf in reversed(final_coeffs):
            val = F.add_ints(F.mul_ints(val, s), cf)
        return val == last_interp
