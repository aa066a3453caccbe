"""LDT instance reducer (port of libiop_tpu/protocols/ldt_reducer.py): every
oracle f_i is combined as sum_i (c_i + c'_i x^{Delta_i}) f_i (c_0 = 1), so
one multi-LDT tests all of them at the maximum degree.  With zk each
combination also takes a random blinding polynomial of the maximum tested
degree, committed in round 0."""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..algebra.domains import device_table
from ..algebra.generic import fft_any
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from ..kernels.ldt_combine import ldt_combine
from .fri import log2_field_size


class LDTReducerSoundnessType:
    proven = "proven"
    optimistic_heuristic = "optimistic_heuristic"


class LDTReducerParams:
    def __init__(self, F, interactive_soundness_bits: int,
                 soundness_type: str, codeword_domain_dim: int,
                 max_tested_degree_bound: int,
                 max_constraint_degree_bound: int, make_zk: bool):
        self.F = F
        self.soundness_type = soundness_type
        self.codeword_domain_dim = codeword_domain_dim
        self.max_tested_degree_bound = max_tested_degree_bound
        self.max_constraint_degree_bound = max_constraint_degree_bound
        self.make_zk = make_zk
        N = 1 << codeword_domain_dim
        if soundness_type == LDTReducerSoundnessType.proven:
            self.absolute_proximity_parameter = min(
                N - max_constraint_degree_bound,
                (N - 2 * max_tested_degree_bound) // 2,
                (N - max_tested_degree_bound) // 3) - 1
        else:
            self.absolute_proximity_parameter = min(
                N - max_constraint_degree_bound,
                N - max_tested_degree_bound) - 1
        denom = codeword_domain_dim - log2_field_size(F)
        self.num_output_LDT_instances = max(
            1, int(math.ceil(-interactive_soundness_bits / denom)))


def x_power_evals(F, L, delta: int, device) -> torch.Tensor:
    """x^delta over L (memoized per device): over a coset shift^delta *
    g^{delta*k}, a strided gather of the generator powers times one scalar;
    over a subspace square and multiply over its elements (K16)."""
    def _compute():
        if L.kind == "affine_subspace":
            return F.pow_static(L.elements(device), delta)
        N = L.order
        idx = (torch.arange(N, dtype=torch.int64, device=device)
               * (delta % N)) % N
        strided = L.generator_powers(device).index_select(1, idx)
        return F.mul(strided, F.from_ints([pow(L.shift, delta, F.p)],
                                          device).reshape(F.L, 1))

    return device_table(("xpow", L._key(), delta), device, _compute)


class CombinedLDTOracle(VirtualOracle):
    """sum_i (c_i + c'_i x^{Delta_i}) f_i over the codeword domain."""

    def __init__(self, F, codeword_domain, input_degrees: List[int]):
        self.F = F
        self.L = codeword_domain
        self.input_degrees = list(input_degrees)
        self.n = len(input_degrees)
        self.max_degree = max(input_degrees)
        self.submaximal = [i for i, d in enumerate(input_degrees)
                           if d < self.max_degree]
        self.num_random_coefficients = 2 * self.n
        self.coefficients: Optional[List[int]] = None

    def set_coefficients(self, random_coeffs: List[int]):
        assert len(random_coeffs) >= self.num_random_coefficients
        self.coefficients = [1] + [self.F.sample_int(int(c))
                                   for c in random_coeffs]

    def traced_aux(self, device):
        """[c_i for every input] + [c'_i for each submaximal input] + [the
        x^{Delta_i} codeword of each submaximal input]."""
        if self.coefficients is None:
            return None
        ns = len(self.submaximal)
        return (self.coefficients[:self.n]
                + self.coefficients[self.n:self.n + ns]
                + [x_power_evals(self.F, self.L,
                                 self.max_degree - self.input_degrees[i],
                                 device) for i in self.submaximal])

    def traced_sig(self):
        return (self.n, tuple(self.submaximal))

    def evaluated_contents(self, constituent_evals):
        """The eager evaluation, one launch of K24 over every input (the
        fused DAG path, K8, takes at most 32 inputs; Ligero's direct LDT
        evaluates its 257-262 eagerly)."""
        assert self.coefficients is not None, "challenge not set"
        dev = constituent_evals[0].device
        sub_coeffs = [None] * self.n
        tables = [None] * self.n
        for sc, i in enumerate(self.submaximal):
            sub_coeffs[i] = self.coefficients[self.n + sc]
            tables[i] = x_power_evals(
                self.F, self.L, self.max_degree - self.input_degrees[i], dev)
        return ldt_combine(self.F, constituent_evals,
                           self.coefficients[:self.n], sub_coeffs, tables)

    def traced_contents(self, F, aux, evals):
        ns = len(self.submaximal)
        cs, cps, bumps = aux[:self.n], aux[self.n:self.n + ns], \
            aux[self.n + ns:]
        acc = None
        sc = 0
        for i, ev in enumerate(evals):
            if i in self.submaximal:
                coeff = F.add(cs[i], F.mul(bumps[sc], cps[sc]))
                sc += 1
            else:
                coeff = cs[i]
            term = F.mul(ev, coeff)
            acc = term if acc is None else F.add(acc, term)
        return acc

    def evaluation_at_point(self, position, x, vals):
        assert self.coefficients is not None, "challenge not set"
        F = self.F
        total = 0
        sub_counter = 0
        for i, v in enumerate(vals):
            c = self.coefficients[i]
            if i in self.submaximal:
                delta = self.max_degree - self.input_degrees[i]
                cp = self.coefficients[self.n + sub_counter]
                sub_counter += 1
                c = F.add_ints(c, F.mul_ints(cp, F.pow_int(x, delta)))
            total = F.add_ints(total, F.mul_ints(c, v))
        return total


class LDTInstanceReducer:
    """Hosts the multi-LDT (FRI) over the combined oracles."""

    def __init__(self, iop: IOPProtocol, codeword_handle,
                 params: LDTReducerParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.codeword_handle = codeword_handle
        self.params = params
        self.L = iop.get_domain(codeword_handle)
        self.rng = rng or np.random.default_rng()
        self.blinding_handles: List[OracleHandle] = []
        if params.make_zk:
            self.blinding_handles = [
                iop.register_oracle(codeword_handle,
                                    params.max_tested_degree_bound,
                                    make_zk=True)
                for _ in range(params.num_output_LDT_instances)]
        self.multi_ldt = None

    def set_ldt(self, ldt_factory):
        self._ldt_factory = ldt_factory

    def register_interactions(self, oracle_handles: List[OracleHandle]):
        self.input_handles = list(oracle_handles)
        degrees = [self.iop.get_oracle_degree_bound(h) for h in oracle_handles]
        for d in degrees:
            assert d <= self.params.max_tested_degree_bound, (
                f"oracle degree {d} exceeds max tested bound "
                f"{self.params.max_tested_degree_bound}")
        zk = self.params.make_zk
        if zk:
            degrees = degrees + [self.params.max_tested_degree_bound]
        self.num_random_coefficients = 2 * len(self.input_handles) + \
            (2 if zk else 0)
        self.combined_oracles: List[CombinedLDTOracle] = []
        self.combined_handles: List[OracleHandle] = []
        for i in range(self.params.num_output_LDT_instances):
            oracle = CombinedLDTOracle(self.F, self.L, degrees)
            self.combined_oracles.append(oracle)
            self.combined_handles.append(self.iop.register_virtual_oracle(
                self.codeword_handle, self.params.max_tested_degree_bound,
                list(self.input_handles)
                + ([self.blinding_handles[i]] if zk else []), oracle))
        self.coefficient_handles = [
            self.iop.register_verifier_random_message(self.num_random_coefficients)
            for _ in range(self.params.num_output_LDT_instances)]
        self.multi_ldt = self._ldt_factory(
            self.iop, self.codeword_handle, self.combined_handles)
        self.multi_ldt.register_interactions()

    def register_queries(self):
        self.multi_ldt.register_queries()

    def submit_masking_polynomial(self):
        """zk: one random polynomial of max_tested_degree_bound
        coefficients per output instance, drawn from the prover's rng."""
        if not self.params.make_zk:
            return
        for h in self.blinding_handles:
            coeffs = self.F.random((self.params.max_tested_degree_bound,),
                                   self.rng, self.iop.device)
            self.iop.submit_oracle(h, fft_any(coeffs, self.L))

    def _set_challenges(self):
        for i, oracle in enumerate(self.combined_oracles):
            oracle.set_coefficients(self.iop.obtain_verifier_random_message(
                self.coefficient_handles[i]))

    def calculate_and_submit_proof(self):
        self._set_challenges()
        self.multi_ldt.calculate_and_submit_proof()

    def verifier_predicate(self) -> bool:
        self._set_challenges()
        return self.multi_ldt.verifier_predicate()
