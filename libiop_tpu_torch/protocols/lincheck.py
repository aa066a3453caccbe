"""Basic multi-lincheck (port of libiop_tpu/protocols/lincheck.py).

The verifier sends alpha and r_M; the virtual oracle is
q(x) = p_alpha^1(x) * sum_M r_M f_Mz(x) - p_alpha^2(x) * f_z(x), with
p_alpha^1 the LDE of the alpha powers placed at the constraint positions of
the summation domain and p_alpha^2 the LDE of sum_M r_M M^T(alpha powers)
placed at the variable positions.  Its sum over the summation domain is 0
iff the linchecks hold (whp), which a batch sumcheck then proves (with a
masking polynomial under zk).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..algebra.domains import device_powers
from ..algebra.generic import fft_any, ifft_any, place_columns
from ..algebra.poly import horner_eval
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from ..utils.profiling import PROFILER
from .fri import log2_field_size
from .sumcheck import BatchSumcheck


class LincheckParams:
    def __init__(self, F, interactive_security_parameter: int,
                 constraint_domain_dim: int, make_zk: bool):
        self.F = F
        self.interactive_security_parameter = interactive_security_parameter
        self.constraint_domain_dim = constraint_domain_dim
        self.make_zk = make_zk
        denom = constraint_domain_dim - log2_field_size(F)
        self.repetitions = max(1, int(math.ceil(
            -interactive_security_parameter / denom)))


class MultiLincheckVirtualOracle(VirtualOracle):
    """q(x) as above; constituents [fz, fAz, fBz, fCz]."""

    def __init__(self, F, codeword_domain, constraint_domain,
                 variable_domain, summation_domain, input_variable_dim: int,
                 matrices):
        self.F = F
        self.L = codeword_domain
        self.constraint_domain = constraint_domain
        self.variable_domain = variable_domain
        self.summation_domain = summation_domain
        self.matrices = matrices
        self.constraint_to_sum = np.array(
            [summation_domain.reindex_by_subgroup(constraint_domain.dim, i)
             for i in range(constraint_domain.order)], dtype=np.int64)
        var_to_var = [variable_domain.reindex_by_subgroup(input_variable_dim, i)
                      for i in range(variable_domain.order)]
        self.var_to_sum = np.array(
            [summation_domain.reindex_by_subgroup(variable_domain.dim, v)
             for v in var_to_var], dtype=np.int64)
        # fixed for the object's life: read-only, so that place_columns
        # keys their device maps on the arrays themselves
        self.constraint_to_sum.setflags(write=False)
        self.var_to_sum.setflags(write=False)
        self._p1_coeffs = None
        self._p2_coeffs = None
        self._p_cw = None
        self._pt_eval_cache = {}

    def set_challenge(self, alpha: int, r_M: List[int], device):
        with PROFILER.block("lincheck_set_challenge"):
            F = self.F
            Hs = self.summation_domain
            alpha_powers = device_powers(
                F, F.from_ints([alpha], device).reshape(F.L),
                self.constraint_domain.order)
            p1 = place_columns(alpha_powers, self.constraint_to_sum, Hs.order)
            acc = None
            for m, M in enumerate(self.matrices):
                term = F.mul(M.matvec_transpose(alpha_powers),
                             F.from_ints([r_M[m]], device).reshape(F.L, 1))
                acc = term if acc is None else F.add(acc, term)
            nv = self.variable_domain.order
            if acc.shape[1] < nv:
                acc = torch.cat([acc, F.zeros((nv - acc.shape[1],), device)],
                                dim=1)
            assert acc.shape[1] == nv, (acc.shape, nv)
            p2 = place_columns(acc, self.var_to_sum, Hs.order)
            self._p1_coeffs = ifft_any(p1, Hs)
            self._p2_coeffs = ifft_any(p2, Hs)
            self._p_cw = None
            self._pt_eval_cache = {}
            self.r_M = [F.sample_int(int(r)) for r in r_M]

    def _p_codewords(self):
        if self._p_cw is None:
            self._p_cw = (fft_any(self._p1_coeffs, self.L),
                          fft_any(self._p2_coeffs, self.L))
        return self._p_cw

    def traced_aux(self, device):
        if self._p1_coeffs is None:
            return None
        return list(self._p_codewords()) + list(self.r_M)

    def traced_contents(self, F, aux, evals):
        p1_cw, p2_cw = aux[:2]
        fz = evals[0]
        combined = None
        for r, ev in zip(aux[2:], evals[1:]):
            term = F.mul(ev, r)
            combined = term if combined is None else F.add(combined, term)
        return F.sub(F.mul(combined, p1_cw), F.mul(fz, p2_cw))

    def prefetch_points(self, positions, points):
        """p_alpha^{1,2} at every query point in one batched Horner and one
        device-to-host transfer (padded to a power of two, as the reference)."""
        F = self.F
        n = len(points)
        m = 1 << max(0, (n - 1).bit_length())
        xl = F.from_ints(list(points) + [0] * (m - n), self._p1_coeffs.device)
        p1 = horner_eval(F, self._p1_coeffs, xl)
        p2 = horner_eval(F, self._p2_coeffs, xl)
        for x, a, b in zip(points, F.to_ints(p1), F.to_ints(p2)):
            self._pt_eval_cache[int(x)] = (int(a), int(b))

    def _eval_p_at(self, x: int):
        hit = self._pt_eval_cache.get(x)
        if hit is None:
            self.prefetch_points([0], [x])
            hit = self._pt_eval_cache[x]
        return hit

    def evaluation_at_point(self, position, x, vals):
        assert self._p1_coeffs is not None, "challenge not set"
        F = self.F
        p1_x, p2_x = self._eval_p_at(x)
        combined = 0
        for r, v in zip(self.r_M, vals[1:]):
            combined = F.add_ints(combined, F.mul_ints(r, v))
        return F.sub_ints(F.mul_ints(combined, p1_x), F.mul_ints(vals[0], p2_x))


class MultiLincheck:
    def __init__(self, iop: IOPProtocol, codeword_handle, constraint_handle,
                 variable_handle, input_variable_dim: int, matrices,
                 fz_handle: OracleHandle, Mz_handles: List[OracleHandle],
                 params: LincheckParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.codeword_handle = codeword_handle
        constraint_domain = iop.get_domain(constraint_handle)
        variable_domain = iop.get_domain(variable_handle)
        self.summation_handle = (constraint_handle
                                 if constraint_domain.dim > variable_domain.dim
                                 else variable_handle)
        summation_domain = iop.get_domain(self.summation_handle)
        self.constituents = [fz_handle] + list(Mz_handles)
        fz_degree = iop.get_oracle_degree_bound(fz_handle)
        Mz_degree = iop.get_oracle_degree_bound(Mz_handles[0])
        self.lincheck_degree = summation_domain.order + max(fz_degree,
                                                            Mz_degree) - 1
        self.sumchecks: List[BatchSumcheck] = []
        self.oracles: List[MultiLincheckVirtualOracle] = []
        for _ in range(params.repetitions):
            sc = BatchSumcheck(iop, self.summation_handle, codeword_handle,
                               self.lincheck_degree, params.make_zk, rng=rng)
            if params.make_zk:
                sc.register_masking_polynomial()
            self.sumchecks.append(sc)
            self.oracles.append(MultiLincheckVirtualOracle(
                self.F, iop.get_domain(codeword_handle), constraint_domain,
                variable_domain, summation_domain, input_variable_dim,
                matrices))

    def register_challenge(self):
        reps = self.params.repetitions
        self.alpha_handles = [self.iop.register_verifier_random_message(1)
                              for _ in range(reps)]
        self.r_handles = [self.iop.register_verifier_random_message(
            len(self.constituents) - 1) for _ in range(reps)]
        for i, sc in enumerate(self.sumchecks):
            h = self.iop.register_virtual_oracle(
                self.codeword_handle, self.lincheck_degree, self.constituents,
                self.oracles[i])
            sc.attach_oracle_for_summing(h, 0)
            sc.register_challenge()

    def register_proof(self):
        for sc in self.sumchecks:
            sc.register_proof()

    def submit_sumcheck_masking_polynomials(self):
        if self.params.make_zk:
            for sc in self.sumchecks:
                sc.submit_masking_polynomial()

    def _set_challenges(self):
        for i in range(self.params.repetitions):
            alpha = self.iop.obtain_verifier_random_message(
                self.alpha_handles[i])[0]
            r_M = self.iop.obtain_verifier_random_message(self.r_handles[i])
            self.oracles[i].set_challenge(alpha, r_M, self.iop.device)

    def calculate_and_submit_proof(self):
        self._set_challenges()
        for sc in self.sumchecks:
            sc.calculate_and_submit_proof()

    def construct_verifier_state(self):
        self._set_challenges()
        for sc in self.sumchecks:
            sc.construct_verifier_state()

    def ldt_oracle_handles(self) -> List[OracleHandle]:
        out = []
        for sc in self.sumchecks:
            out.extend(sc.ldt_oracle_handles())
        return out
