"""Holographic multi-lincheck, Fractal's two-challenge lincheck (port of
libiop_tpu/protocols/holographic_lincheck.py).

* challenge alpha (+ r_M): the prover sends t, the LDE over H of
  sum_M r_M M^T p_alpha (p_alpha the unnormalized Lagrange polynomial of
  H at alpha), and the virtual oracle
      q(x) = p_alpha(x) sum_M r_M f_Mz(x) - t(x) f_z(x)
  joins a batch sumcheck over H with claimed sum 0;
* challenge beta (+ the sumcheck's): the prover sends M'(alpha, beta); a
  boundary constraint ties t(beta) to it, and a rational sumcheck over the
  index domain K checks M'(alpha, beta) = sum_K N/D with
      N = sum_M r_M Z_H(alpha) Z_H(beta) val_M,
      D_M = (row_M - beta)(col_M - alpha)
  through the indexed row, col, val and row*col oracles.

On the card p_alpha over L and over H are one K20 launch each over a
prime field (the inverse of alpha - x fused with the product by its
numerator; a K16 inverse and product over GF(2^k)) and sum_M r_M M^T
p_alpha, placed into the variable slots, is one K21 launch (its GF(2^k)
instantiation over a binary field).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..algebra.domains import device_table
from ..algebra.generic import (fft_any, ifft_any,
                               lagrange_poly_eval_at_point_int_any,
                               lagrange_poly_evals_over_any,
                               vanishing_eval_int)
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from ..kernels.p_alpha_m import p_alpha_m
from .common import RationalLinearCombination, SingleBoundaryConstraint
from .fri import log2_field_size
from .rational_sumcheck import RationalSumcheck
from .sumcheck import BatchSumcheck


class HolographicLincheckParams:
    def __init__(self, F, interactive_security_parameter: int,
                 constraint_domain_dim: int, make_zk: bool):
        self.F = F
        self.constraint_domain_dim = constraint_domain_dim
        self.make_zk = make_zk
        per_rep = (1 + constraint_domain_dim) - log2_field_size(F)
        self.num_repetitions = max(1, int(
            math.ceil(-interactive_security_parameter / per_rep)))

    def tested_degree_bound(self) -> int:
        return 3 * (1 << self.constraint_domain_dim)

    def constraint_degree_bound(self) -> int:
        return 4 * (1 << self.constraint_domain_dim)


class HolographicLincheckVirtualOracle(VirtualOracle):
    """q(x) = p_alpha(x) sum_M r_M f_Mz(x) - t(x) f_z(x); constituents
    [fz, fAz, fBz, fCz, t].  p_alpha over L enters the DAG as a codeword,
    computed once per alpha (K20)."""

    def __init__(self, F, codeword_domain, summation_domain,
                 num_matrices: int):
        self.F = F
        self.L = codeword_domain
        self.H = summation_domain
        self.num_matrices = num_matrices
        self.alpha: Optional[int] = None
        self._p_alpha_cw = None

    def set_challenge(self, alpha: int, r_Mz: List[int]):
        self.alpha = self.F.sample_int(alpha)
        self.r_Mz = [self.F.sample_int(int(r)) for r in r_Mz]
        self._p_alpha_cw = None

    def traced_aux(self, device):
        if self.alpha is None:
            return None
        if self._p_alpha_cw is None:
            self._p_alpha_cw = lagrange_poly_evals_over_any(
                self.H, self.alpha, self.L, device)
        return [self._p_alpha_cw] + list(self.r_Mz)

    def traced_sig(self):
        return (self.num_matrices,)

    def traced_contents(self, F, aux, evals):
        p_alpha, rs = aux[0], aux[1:]
        combined = None
        for m in range(self.num_matrices):
            term = F.mul(evals[m + 1], rs[m])
            combined = term if combined is None else F.add(combined, term)
        return F.sub(F.mul(combined, p_alpha),
                     F.mul(evals[0], evals[self.num_matrices + 1]))

    def evaluation_at_point(self, position, x, vals):
        assert self.alpha is not None
        F = self.F
        fz, t = vals[0], vals[self.num_matrices + 1]
        pa = lagrange_poly_eval_at_point_int_any(self.H, self.alpha, x)
        combined = 0
        for r, v in zip(self.r_Mz, vals[1:]):
            combined = F.add_ints(combined, F.mul_ints(r, v))
        return F.sub_ints(F.mul_ints(combined, pa), F.mul_ints(fz, t))


class SingleMatrixDenominator(VirtualOracle):
    """(row(x) - row_qp)(col(x) - col_qp), expanded through the row, col
    and row*col oracles."""

    def __init__(self, F):
        self.F = F
        self.row_qp: Optional[int] = None
        self.col_qp: Optional[int] = None

    def set_challenge(self, row_query_point: int, col_query_point: int):
        self.row_qp = self.F.sample_int(row_query_point)
        self.col_qp = self.F.sample_int(col_query_point)

    def traced_aux(self, device):
        if self.row_qp is None:
            return None
        F = self.F
        return [F.neg_int(self.col_qp), F.neg_int(self.row_qp),
                F.mul_ints(self.row_qp, self.col_qp)]

    def traced_contents(self, F, aux, evals):
        a, b, c = aux
        row, col, rowcol = evals
        out = F.add(F.mul(row, a), F.mul(col, b))
        return F.add(F.add(out, rowcol), c)

    def evaluation_at_point(self, position, x, vals):
        assert self.row_qp is not None
        F = self.F
        row, col, rowcol = vals
        out = F.sub_ints(rowcol, F.mul_ints(self.col_qp, row))
        out = F.sub_ints(out, F.mul_ints(self.row_qp, col))
        return F.add_ints(out, F.mul_ints(self.row_qp, self.col_qp))


def compute_p_alpha_M_evals(F, input_variable_dim: int, summation_domain,
                            p_alpha_over_H, r_Mz: List[int], matrices):
    """(L, |H|) sum_M r_M (M^T p_alpha) placed into the variable slots
    Hs.reindex_by_subgroup(input_variable_dim, j), zero beyond the
    matrices' columns: one K21 launch over the matrices' M^T in CSR form."""
    Hs = summation_domain
    dev = p_alpha_over_H.device
    nv = Hs.order
    S = matrices[0].num_cols
    assert all(M.num_cols == S and M.num_rows <= p_alpha_over_H.shape[1]
               for M in matrices)

    def inverse_placement():
        inv = np.full(nv, S, dtype=np.int64)
        for j in range(min(nv, S)):
            inv[Hs.reindex_by_subgroup(input_variable_dim, j)] = j
        return inv

    inv = device_table(("p_alpha_M_place", Hs._key(), input_variable_dim, S),
                       dev, inverse_placement)
    return p_alpha_m(F, [M.transpose_csr_device(dev) for M in matrices],
                     p_alpha_over_H.contiguous(), list(r_Mz), inv, S)


class HolographicMultiLincheck:
    def __init__(self, iop: IOPProtocol, codeword_handle, summation_handle,
                 input_variable_dim: int, matrices,
                 fz_handle: OracleHandle, Mz_handles: List[OracleHandle],
                 params: HolographicLincheckParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.codeword_handle = codeword_handle
        self.summation_handle = summation_handle
        self.H = iop.get_domain(summation_handle)
        self.L = iop.get_domain(codeword_handle)
        self.input_variable_dim = input_variable_dim
        self.matrices = matrices
        self.num_matrices = len(matrices)
        self.constituents = [fz_handle] + list(Mz_handles)
        fz_degree = iop.get_oracle_degree_bound(fz_handle)
        Mz_degree = iop.get_oracle_degree_bound(Mz_handles[0])
        self.lincheck_degree = self.H.order + max(fz_degree, Mz_degree) - 1
        self.sumcheck_H: List[BatchSumcheck] = []
        self.lincheck_oracles: List[HolographicLincheckVirtualOracle] = []
        self.t_boundary: List[SingleBoundaryConstraint] = []
        for _ in range(params.num_repetitions):
            sc = BatchSumcheck(iop, summation_handle, codeword_handle,
                               self.lincheck_degree, params.make_zk, rng=rng)
            if params.make_zk:
                sc.register_masking_polynomial()
            self.sumcheck_H.append(sc)
            self.lincheck_oracles.append(HolographicLincheckVirtualOracle(
                self.F, self.L, self.H, self.num_matrices))
            self.t_boundary.append(SingleBoundaryConstraint(self.F, self.L))

    def set_index_oracles(self, index_handle, indexed_handles):
        """indexed_handles: per matrix, [row, col, val, row*col]."""
        assert len(indexed_handles) == self.num_matrices
        self.index_handle = index_handle
        self.K = self.iop.get_domain(index_handle)
        k = self.K.order
        n = self.num_matrices
        self.combined_num_degree = k + (n - 1) * k - (n - 1)
        self.combined_den_degree = n * k - (n - 1)
        self.matrix_denominators = []
        self.matrix_numerator_handles = []
        self.matrix_denominator_handles = []
        self.sumcheck_K: List[RationalSumcheck] = []
        for _ in range(self.params.num_repetitions):
            dens, num_hs, den_hs = [], [], []
            for row_h, col_h, val_h, rc_h in indexed_handles:
                den_oracle = SingleMatrixDenominator(self.F)
                den_hs.append(self.iop.register_virtual_oracle(
                    self.codeword_handle, k, [row_h, col_h, rc_h],
                    den_oracle))
                dens.append(den_oracle)
                num_hs.append(val_h)
            self.matrix_denominators.append(dens)
            self.matrix_numerator_handles.append(num_hs)
            self.matrix_denominator_handles.append(den_hs)
            self.sumcheck_K.append(RationalSumcheck(
                self.iop, self.index_handle, self.codeword_handle,
                self.combined_num_degree, self.combined_den_degree))

    # -- registration ------------------------------------------------------
    def register_challenge_alpha(self):
        reps = self.params.num_repetitions
        self.alpha_handles = [self.iop.register_verifier_random_message(1)
                              for _ in range(reps)]
        self.r_handles = [self.iop.register_verifier_random_message(
            self.num_matrices) for _ in range(reps)]

    def register_response_alpha(self):
        self.t_handles = []
        self.lincheck_handles = []
        for rep in range(self.params.num_repetitions):
            t_h = self.iop.register_oracle(self.codeword_handle, self.H.order,
                                           make_zk=False)
            self.t_handles.append(t_h)
            lh = self.iop.register_virtual_oracle(
                self.codeword_handle, self.lincheck_degree,
                self.constituents + [t_h], self.lincheck_oracles[rep])
            self.lincheck_handles.append(lh)
            self.sumcheck_H[rep].attach_oracle_for_summing(lh, 0)

    def register_challenge_beta(self):
        reps = self.params.num_repetitions
        self.beta_handles = [self.iop.register_verifier_random_message(1)
                             for _ in range(reps)]
        for rep in range(reps):
            self.sumcheck_H[rep].register_challenge()

    def register_response_beta(self):
        reps = self.params.num_repetitions
        self.M_at_alpha_beta = [self.iop.register_prover_message(1)
                                for _ in range(reps)]
        self.rational_lc: List[RationalLinearCombination] = []
        self.t_boundary_handles = []
        for rep in range(reps):
            rlc = RationalLinearCombination(
                self.iop, self.num_matrices,
                self.matrix_numerator_handles[rep],
                self.matrix_denominator_handles[rep], self.codeword_handle,
                self.combined_num_degree, self.combined_den_degree)
            self.rational_lc.append(rlc)
            self.sumcheck_K[rep].register_summation_oracle(
                rlc.numerator_handle, rlc.denominator_handle)
            self.t_boundary_handles.append(self.iop.register_virtual_oracle(
                self.codeword_handle, self.H.order - 1,
                [self.t_handles[rep]], self.t_boundary[rep]))
            self.sumcheck_H[rep].register_proof()
            self.sumcheck_K[rep].register_proof()

    # -- proving -----------------------------------------------------------
    def submit_sumcheck_masking_polynomials(self):
        if self.params.make_zk:
            for sc in self.sumcheck_H:
                sc.submit_masking_polynomial()

    def _challenges(self, rep):
        alpha = self.iop.obtain_verifier_random_message(
            self.alpha_handles[rep])[0]
        r_Mz = self.iop.obtain_verifier_random_message(self.r_handles[rep])
        return alpha, r_Mz

    def calculate_response_alpha(self):
        F = self.F
        dev = self.iop.device
        for rep in range(self.params.num_repetitions):
            alpha, r_Mz = self._challenges(rep)
            p_alpha_over_H = lagrange_poly_evals_over_any(
                self.H, alpha, self.H, dev)
            p_alpha_M_over_H = compute_p_alpha_M_evals(
                F, self.input_variable_dim, self.H, p_alpha_over_H, r_Mz,
                self.matrices)
            self.iop.submit_oracle(self.t_handles[rep], fft_any(
                ifft_any(p_alpha_M_over_H, self.H), self.L))
            self.lincheck_oracles[rep].set_challenge(alpha, r_Mz)

    def _set_beta_state(self, rep):
        F = self.F
        alpha, r_Mz = self._challenges(rep)
        beta = self.iop.obtain_verifier_random_message(
            self.beta_handles[rep])[0]
        shift = F.mul_ints(vanishing_eval_int(self.H, alpha),
                           vanishing_eval_int(self.H, beta))
        coeffs = [F.mul_ints(shift, F.sample_int(int(r))) for r in r_Mz]
        self.rational_lc[rep].set_coefficients(coeffs)
        for den in self.matrix_denominators[rep]:
            den.set_challenge(beta, alpha)
        return beta, coeffs

    def calculate_response_beta(self):
        F = self.F
        for rep in range(self.params.num_repetitions):
            beta, coeffs = self._set_beta_state(rep)
            nums_over_K, dens_over_K = [], []
            for i in range(self.num_matrices):
                row, col, val, rc = self._index_vectors[i]
                nums_over_K.append(val)
                dens_over_K.append(self.matrix_denominators[rep][i]
                                   .evaluated_contents([row, col, rc]))
            combined = RationalLinearCombination.values_over_K(
                F, coeffs, nums_over_K, dens_over_K)
            self.sumcheck_K[rep].calculate_and_submit_proof(combined)
            mab = self.sumcheck_K[rep].get_claimed_sum()
            self.iop.submit_prover_message(self.M_at_alpha_beta[rep], [mab])
            self.t_boundary[rep].set_evaluation_point_and_eval(beta, mab)
            self.sumcheck_H[rep].calculate_and_submit_proof()

    def set_index_vectors_over_K(self, vectors_per_matrix):
        """Prover side: per matrix the (row, col, val, row*col) tensors over
        K, as the indexer computed them."""
        self._index_vectors = vectors_per_matrix

    # -- verification ------------------------------------------------------
    def construct_verifier_state(self):
        for rep in range(self.params.num_repetitions):
            alpha, r_Mz = self._challenges(rep)
            self.lincheck_oracles[rep].set_challenge(alpha, r_Mz)
            beta, _ = self._set_beta_state(rep)
            mab = self.iop.receive_prover_message(self.M_at_alpha_beta[rep])[0]
            self.t_boundary[rep].set_evaluation_point_and_eval(beta, mab)
            self.sumcheck_H[rep].construct_verifier_state()
            self.sumcheck_K[rep].construct_verifier_state(mab)

    def ldt_oracle_handles(self) -> List[OracleHandle]:
        out = []
        for rep in range(self.params.num_repetitions):
            out.append(self.t_handles[rep])
            out.append(self.t_boundary_handles[rep])
            out.extend(self.sumcheck_H[rep].ldt_oracle_handles())
            out.extend(self.sumcheck_K[rep].ldt_oracle_handles())
        return out
