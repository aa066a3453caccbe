"""Ligero: the interleaved Reed-Solomon R1CS protocol (port of
libiop_tpu/protocols/ligero.py, multiplicative cosets and affine
subspaces).

* The witness z (width-padded) is packed into a matrix of rows of length
  |H| (the systematic domain); each row is RS-encoded over the codeword
  domain as one oracle, and so are the target vectors Az, Bz, Cz.
* Lincheck-OT: per interaction the verifier sends r over the padded
  constraint rows; the prover answers with the coefficients of
      p0 = sum_i r_blk_i * f_{target,i} - sum_i s_blk_i * f_{input,i} (+ blind)
  where s = M^T r; the verifier checks that p0 sums to 0 over H and agrees
  with the oracles at the queried columns.
* Rowcheck: p0 = sum_i r_i (f_a_i f_b_i - f_c_i) (+ blind) must vanish on H
  and agree with the oracles at the queried columns.
* zk: blinding rows summing to zero over H / vanishing on H, salted trees.

On the card every row encode (systematic domain to codeword domain, and
the zk row blinding oracle's extended domain to codeword domain) is one
launch of kernel K14 (kernels/rs_encode.py) over a prime field, and one
batched additive IFFT and FFT (kernel K17) over a binary field; every sum
over rows of a product is one launch of kernel K15 (kernels/row_dot.py,
an XOR sum over GF(2^k)), which never writes the (rows, N) product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..algebra.generic import (element_outside_of_subset, fft_any, ifft_any,
                               make_domain)
from ..algebra.poly import horner_eval
from ..iop.runtime import IOPProtocol, OracleHandle
from ..kernels.row_dot import row_dot
from ..kernels.rs_encode import rs_encode
from ..relations.sparse import SparseMatrix
from ..utils.profiling import PROFILER
from .common import lazy_linear_combination
from .direct_ldt import DirectLDT, DirectLDTParams
from .fri import log2_field_size
from .ldt_reducer import (LDTInstanceReducer, LDTReducerParams,
                          LDTReducerSoundnessType)


def _responses_at_positions(F, resp_dev, L, positions: List[int]) -> List[int]:
    """response(x_j) at every queried column in one K10 evaluation, the
    points padded to a power of two as the reference pads them."""
    n = len(positions)
    m = 1 << max(0, (n - 1).bit_length())
    xs = F.from_ints([L.element_by_index_int(int(j)) for j in positions]
                     + [0] * (m - n), resp_dev.device)
    return [int(v) for v in F.to_ints(horner_eval(F, resp_dev, xs))[:n]]


@dataclasses.dataclass
class EncodedLigeroParams:
    make_zk: bool
    matrix_width: int
    matrix_height: int
    num_oracles_input: int
    num_oracles_vectors: int
    num_interactions: int = 1
    num_queries: int = 1
    encoding_independence: int = 3


def _encode_rows(F, rows_mat, systematic_domain, codeword_domain):
    """(L, R, |H|) systematic values -> (L, R, |L|) codewords: K14 over a
    multiplicative coset; over an affine subspace the reference's ifft_any
    then fft_any (ligero.py:86-89), each one batched K17 transform."""
    if F.kind == "additive":
        return fft_any(ifft_any(rows_mat.contiguous(), systematic_domain),
                       codeword_domain)
    return rs_encode(F, rows_mat.contiguous(), systematic_domain,
                     codeword_domain)


def _row_sum(F, a, b):
    """sum_i a[:, i, :] * b[:, i, :] over the row axis of (L, R, N)
    tensors (K15: the products are never written; an XOR fold over
    GF(2^k), ligero.py:92-101)."""
    return row_dot(F, a.contiguous(), b.contiguous())


def _columns(F, t, pos_arr):
    """Canonical ints of t (L, R, N) at the queried columns: (R, q)."""
    return F.to_ints(t.index_select(2, pos_arr))


def _sums_over_systematic(F, resp_dev, H, extended):
    """The response's values over H (via the extended domain), canonical
    ints."""
    ext_evals = fft_any(resp_dev, extended)
    idx = torch.tensor([extended.reindex_by_subgroup(H.dim, d)
                        for d in range(H.order)], dtype=torch.int64,
                       device=resp_dev.device)
    return F.to_ints(ext_evals.index_select(1, idx))


def _submit_response(iop, handle, resp, L, size):
    coeffs = ifft_any(resp, L)
    iop.submit_prover_message(
        handle, [int(v) for v in iop.F.to_ints(coeffs[:, :size])])


class InterleavedLincheckOT:
    def __init__(self, iop, codeword_h, systematic_h, extended_h,
                 num_oracles_input: int, num_oracles_target: int,
                 num_queries: int, num_interactions: int, make_zk: bool,
                 matrix: SparseMatrix):
        self.iop = iop
        self.F = iop.F
        self.codeword_h = codeword_h
        self.L = iop.get_domain(codeword_h)
        self.H = iop.get_domain(systematic_h)
        self.extended = iop.get_domain(extended_h)
        self.num_oracles_input = num_oracles_input
        self.num_oracles_target = num_oracles_target
        self.num_queries = num_queries
        self.num_interactions = num_interactions
        self.make_zk = make_zk
        self.matrix = matrix  # height x width
        self.response_size = 2 * self.H.order
        self.input_handles: List[OracleHandle] = []
        self.target_handles: List[OracleHandle] = []
        self.blinding_handles: List[OracleHandle] = []

    def attach_input_vector_row_oracles(self, handles):
        self.input_handles = list(handles)

    def attach_target_vector_row_oracles(self, handles):
        self.target_handles = list(handles)

    def attach_blinding_vector_row_oracles(self, handles):
        self.blinding_handles = list(handles)

    def register_linear_combinations(self):
        self.rlc_handles = [
            self.iop.register_verifier_random_message(self.matrix.num_rows)
            for _ in range(self.num_interactions)]

    def register_responses(self):
        self.response_handles = [
            self.iop.register_prover_message(self.response_size)
            for _ in range(self.num_interactions)]

    def register_queries_for_given_positions(self, position_handles):
        self.position_handles = list(position_handles)
        self.input_queries = [
            [self.iop.register_query(h, pos) for h in self.input_handles]
            for pos in self.position_handles]
        self.target_queries = [
            [self.iop.register_query(h, pos) for h in self.target_handles]
            for pos in self.position_handles]
        if self.make_zk:
            self.blinding_queries = [
                [self.iop.register_query(h, pos) for h in self.blinding_handles]
                for pos in self.position_handles]

    def all_random_linear_combinations(self):
        return [self.iop.obtain_verifier_random_message(h)
                for h in self.rlc_handles]

    # -- shared prover/verifier math --------------------------------------
    def _blocks(self, vec_ints, num_blocks):
        """Host ints -> (L, num_blocks, |H|) Montgomery systematic values."""
        h = self.H.order
        vals = list(vec_ints) + [0] * (num_blocks * h - len(vec_ints))
        return self.F.from_ints(np.array(vals, dtype=object).reshape(
            num_blocks, h), self.iop.device)

    def _r_and_s_codewords(self, r: List[int]):
        """The codewords of r split into target blocks and of s = M^T r
        split into input blocks."""
        F = self.F
        r_dev = F.from_ints(r, self.iop.device)
        s_dev = self.matrix.matvec_transpose(r_dev)  # (L, width)
        r_blocks = r_dev.reshape(F.L, self.num_oracles_target, self.H.order)
        s_blocks = s_dev.reshape(F.L, self.num_oracles_input, self.H.order)
        return (_encode_rows(F, r_blocks, self.H, self.L),
                _encode_rows(F, s_blocks, self.H, self.L))

    def _supplementary_codewords(self, supplementary_input: List[int]):
        return _encode_rows(
            self.F, self._blocks(supplementary_input, self.num_oracles_input),
            self.H, self.L)

    def calculate_and_submit_responses(self, supplementary_input: List[int],
                                       rlcs: List[List[int]]):
        F = self.F
        supp_in = self._supplementary_codewords(supplementary_input)
        target_evals = torch.stack(
            [self.iop.get_oracle_evaluations(h) for h in self.target_handles],
            dim=1)
        input_evals = torch.stack(
            [self.iop.get_oracle_evaluations(h) for h in self.input_handles],
            dim=1)
        input_evals = F.add(input_evals, supp_in)
        for h_idx in range(self.num_interactions):
            r_cw, s_cw = self._r_and_s_codewords(rlcs[h_idx])
            resp = F.sub(_row_sum(F, r_cw, target_evals),
                         _row_sum(F, s_cw, input_evals))
            if self.make_zk:
                resp = F.add(resp, self.iop.get_oracle_evaluations(
                    self.blinding_handles[h_idx]))
            _submit_response(self.iop, self.response_handles[h_idx], resp,
                             self.L, self.response_size)

    def verifier_predicate(self, supplementary_input: List[int],
                           rlcs: List[List[int]]) -> bool:
        F = self.F
        dev = self.iop.device
        supp_in = self._supplementary_codewords(supplementary_input)
        positions = [self.iop.obtain_query_position(ph)
                     for ph in self.position_handles]
        pos_arr = torch.tensor(positions, dtype=torch.int64, device=dev)
        supp_cols = _columns(F, supp_in, pos_arr)
        for h_idx in range(self.num_interactions):
            response = self.iop.receive_prover_message(
                self.response_handles[h_idx])
            # equality: the response sums to 0 over the systematic domain
            resp_dev = F.from_ints(response, dev)
            total = 0
            for v in _sums_over_systematic(F, resp_dev, self.H, self.extended):
                total = F.add_ints(total, int(v))
            if total != 0:
                return False
            # consistency at each queried column
            r_cw, s_cw = self._r_and_s_codewords(rlcs[h_idx])
            r_cols = _columns(F, r_cw, pos_arr)
            s_cols = _columns(F, s_cw, pos_arr)
            resp_at = _responses_at_positions(F, resp_dev, self.L, positions)
            for k in range(len(positions)):
                lhs = 0
                for i in range(self.num_oracles_target):
                    tv = self.iop.obtain_query_response(self.target_queries[k][i])
                    lhs = F.add_ints(lhs, F.mul_ints(int(r_cols[i, k]), tv))
                for i in range(self.num_oracles_input):
                    iv = F.add_ints(self.iop.obtain_query_response(
                        self.input_queries[k][i]), int(supp_cols[i, k]))
                    lhs = F.sub_ints(lhs, F.mul_ints(int(s_cols[i, k]), iv))
                if self.make_zk:
                    lhs = F.add_ints(lhs, self.iop.obtain_query_response(
                        self.blinding_queries[k][h_idx]))
                if lhs != resp_at[k]:
                    return False
        return True


class InterleavedLincheckET:
    """Interleaved lincheck with an explicit public target vector b: the
    message encoded by the row oracles satisfies M x = b ([ACIV17] 4.2).
    Tested, but not on the main Ligero path (which routes targets through
    oracles, the OT variant).  Both domain families.

    Per interaction the verifier sends r (one entry per matrix row); the
    prover answers with the low coefficients of q = sum_i s_i U_i
    (+ blinding), s = M^T r split into row blocks.  The verifier checks
    sum_{d in H} q(zeta_d) = r^T b and q against the row oracles at each
    queried column."""

    def __init__(self, iop, codeword_h, systematic_h, extended_h,
                 num_oracles: int, num_queries: int, num_interactions: int,
                 make_zk: bool, matrix: SparseMatrix,
                 target_vector: List[int]):
        self.iop = iop
        self.F = iop.F
        self.codeword_h = codeword_h
        self.L = iop.get_domain(codeword_h)
        self.H = iop.get_domain(systematic_h)
        self.extended = iop.get_domain(extended_h)
        self.num_oracles = num_oracles
        self.num_queries = num_queries
        self.num_interactions = num_interactions
        self.make_zk = make_zk
        self.matrix = matrix
        self.target_vector = list(target_vector)
        assert len(self.target_vector) == matrix.num_rows
        self.response_size = 2 * self.H.order
        self.input_handles: List[OracleHandle] = []
        self.blinding_handles: List[OracleHandle] = []

    def attach_input_vector_row_oracles(self, handles):
        assert len(handles) == self.num_oracles
        self.input_handles = list(handles)

    def attach_blinding_vector_row_oracles(self, handles):
        assert len(handles) == self.num_interactions
        self.blinding_handles = list(handles)

    def register_linear_combinations(self):
        self.rlc_handles = [
            self.iop.register_verifier_random_message(self.matrix.num_rows)
            for _ in range(self.num_interactions)]

    def register_responses(self):
        self.response_handles = [
            self.iop.register_prover_message(self.response_size)
            for _ in range(self.num_interactions)]

    def register_queries(self):
        self.register_queries_for_given_positions([
            self.iop.register_random_query_position(self.codeword_h)
            for _ in range(self.num_queries)])

    def register_queries_for_given_positions(self, position_handles):
        self.position_handles = list(position_handles)
        self.input_queries = [
            [self.iop.register_query(h, pos) for h in self.input_handles]
            for pos in self.position_handles]
        if self.make_zk:
            self.blinding_queries = [
                [self.iop.register_query(h, pos) for h in self.blinding_handles]
                for pos in self.position_handles]

    def _s_codewords(self, r: List[int]):
        """The codewords of s = M^T r split into row blocks."""
        F = self.F
        s_dev = self.matrix.matvec_transpose(F.from_ints(r, self.iop.device))
        return _encode_rows(
            F, s_dev.reshape(F.L, self.num_oracles, self.H.order), self.H,
            self.L)

    def calculate_and_submit_responses(self):
        F = self.F
        input_evals = torch.stack(
            [self.iop.get_oracle_evaluations(h) for h in self.input_handles],
            dim=1)
        for h_idx in range(self.num_interactions):
            r = self.iop.obtain_verifier_random_message(
                self.rlc_handles[h_idx])
            resp = _row_sum(F, self._s_codewords(r), input_evals)
            if self.make_zk:
                resp = F.add(resp, self.iop.get_oracle_evaluations(
                    self.blinding_handles[h_idx]))
            _submit_response(self.iop, self.response_handles[h_idx], resp,
                             self.L, self.response_size)

    def verifier_predicate(self) -> bool:
        F = self.F
        dev = self.iop.device
        for h_idx in range(self.num_interactions):
            r = self.iop.obtain_verifier_random_message(
                self.rlc_handles[h_idx])
            response = self.iop.receive_prover_message(
                self.response_handles[h_idx])
            # equality: the sum of q over the systematic domain is r^T b
            resp_dev = F.from_ints(response, dev)
            lhs = 0
            for v in _sums_over_systematic(F, resp_dev, self.H, self.extended):
                lhs = F.add_ints(lhs, int(v))
            rhs = 0
            for rj, bj in zip(r, self.target_vector):
                rhs = F.add_ints(rhs, F.mul_ints(rj, bj))
            if lhs != rhs:
                return False
            # consistency at each queried column
            positions = [self.iop.obtain_query_position(ph)
                         for ph in self.position_handles]
            pos_arr = torch.tensor(positions, dtype=torch.int64, device=dev)
            s_cols = _columns(F, self._s_codewords(r), pos_arr)
            resp_at = _responses_at_positions(F, resp_dev, self.L, positions)
            for k in range(len(positions)):
                acc = 0
                for i in range(self.num_oracles):
                    uv = self.iop.obtain_query_response(
                        self.input_queries[k][i])
                    acc = F.add_ints(acc, F.mul_ints(int(s_cols[i, k]), uv))
                if self.make_zk:
                    acc = F.add_ints(acc, self.iop.obtain_query_response(
                        self.blinding_queries[k][h_idx]))
                if acc != resp_at[k]:
                    return False
        return True


class InterleavedRowcheck:
    def __init__(self, iop, codeword_h, systematic_h, extended_h,
                 num_oracles: int, num_queries: int, num_interactions: int,
                 make_zk: bool):
        self.iop = iop
        self.F = iop.F
        self.L = iop.get_domain(codeword_h)
        self.H = iop.get_domain(systematic_h)
        self.extended = iop.get_domain(extended_h)
        self.num_oracles = num_oracles
        self.num_queries = num_queries
        self.num_interactions = num_interactions
        self.make_zk = make_zk
        self.response_size = 2 * self.H.order
        self.blinding_handles: List[OracleHandle] = []

    def attach_vector_row_oracles(self, xs, ys, zs):
        self.x_handles, self.y_handles, self.z_handles = list(xs), list(ys), list(zs)

    def attach_blinding_vector_row_oracles(self, handles):
        self.blinding_handles = list(handles)

    def register_linear_combinations(self):
        self.rlc_handles = [
            self.iop.register_verifier_random_message(self.num_oracles)
            for _ in range(self.num_interactions)]

    def register_responses(self):
        self.response_handles = [
            self.iop.register_prover_message(self.response_size)
            for _ in range(self.num_interactions)]

    def register_queries_for_given_positions(self, position_handles):
        self.position_handles = list(position_handles)
        self.x_queries = [[self.iop.register_query(h, pos) for h in self.x_handles]
                          for pos in self.position_handles]
        self.y_queries = [[self.iop.register_query(h, pos) for h in self.y_handles]
                          for pos in self.position_handles]
        self.z_queries = [[self.iop.register_query(h, pos) for h in self.z_handles]
                          for pos in self.position_handles]
        if self.make_zk:
            self.blinding_queries = [
                [self.iop.register_query(h, pos) for h in self.blinding_handles]
                for pos in self.position_handles]

    def calculate_and_submit_responses(self):
        F = self.F

        def stacked(handles):
            return torch.stack([self.iop.get_oracle_evaluations(h)
                                for h in handles], dim=1)

        vals = F.sub(F.mul(stacked(self.x_handles), stacked(self.y_handles)),
                     stacked(self.z_handles))  # (L, R, N)
        for h_idx in range(self.num_interactions):
            r = self.iop.obtain_verifier_random_message(self.rlc_handles[h_idx])
            resp = lazy_linear_combination(F, r, vals)
            if self.make_zk:
                resp = F.add(resp, self.iop.get_oracle_evaluations(
                    self.blinding_handles[h_idx]))
            _submit_response(self.iop, self.response_handles[h_idx], resp,
                             self.L, self.response_size)

    def verifier_predicate(self) -> bool:
        F = self.F
        for h_idx in range(self.num_interactions):
            response = self.iop.receive_prover_message(self.response_handles[h_idx])
            resp_dev = F.from_ints(response, self.iop.device)
            if any(int(v) != 0 for v in _sums_over_systematic(
                    F, resp_dev, self.H, self.extended)):
                return False
            r = self.iop.obtain_verifier_random_message(self.rlc_handles[h_idx])
            positions = [self.iop.obtain_query_position(ph)
                         for ph in self.position_handles]
            resp_at = _responses_at_positions(F, resp_dev, self.L, positions)
            for k in range(len(positions)):
                lhs = 0
                for i in range(self.num_oracles):
                    xv = self.iop.obtain_query_response(self.x_queries[k][i])
                    yv = self.iop.obtain_query_response(self.y_queries[k][i])
                    zv = self.iop.obtain_query_response(self.z_queries[k][i])
                    lhs = F.add_ints(lhs, F.mul_ints(
                        F.sample_int(int(r[i])),
                        F.sub_ints(F.mul_ints(xv, yv), zv)))
                if self.make_zk:
                    lhs = F.add_ints(lhs, self.iop.obtain_query_response(
                        self.blinding_queries[k][h_idx]))
                if lhs != resp_at[k]:
                    return False
        return True


class InterleavedR1CS:
    """Glue: witness packing, oracle registration, sub-protocol wiring."""

    def __init__(self, iop: IOPProtocol, codeword_h, systematic_h, extended_h,
                 r1cs, params: EncodedLigeroParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.r1cs = r1cs
        self.params = params
        self.rng = rng or np.random.default_rng()
        self.codeword_h = codeword_h
        self.L = iop.get_domain(codeword_h)
        self.H = iop.get_domain(systematic_h)
        self.extended = iop.get_domain(extended_h)
        F = self.F
        pr = params
        # padded matrices (height x width) over z indices
        self.padded = [SparseMatrix(F, pr.matrix_height, pr.matrix_width,
                                    M.rows, M.cols, M.vals)
                       for M in r1cs.matrices()]
        self.linchecks = [InterleavedLincheckOT(
            iop, codeword_h, systematic_h, extended_h, pr.num_oracles_input,
            pr.num_oracles_vectors, pr.num_queries, pr.num_interactions,
            pr.make_zk, Mp) for Mp in self.padded]
        self.rowcheck = InterleavedRowcheck(
            iop, codeword_h, systematic_h, extended_h, pr.num_oracles_vectors,
            pr.num_queries, pr.num_interactions, pr.make_zk)
        degree = self.H.order
        self.w_handles = [iop.register_oracle(codeword_h, degree, pr.make_zk)
                          for _ in range(pr.num_oracles_input)]
        self.a_handles, self.b_handles, self.c_handles = [], [], []
        for _ in range(pr.num_oracles_vectors):
            self.a_handles.append(iop.register_oracle(codeword_h, degree, pr.make_zk))
            self.b_handles.append(iop.register_oracle(codeword_h, degree, pr.make_zk))
            self.c_handles.append(iop.register_oracle(codeword_h, degree, pr.make_zk))
        self.blinding = {}
        if pr.make_zk:
            for key in ["A", "B", "C", "row"]:
                self.blinding[key] = [
                    iop.register_oracle(codeword_h, degree, True)
                    for _ in range(pr.num_interactions)]
        # wire up
        for lc, key, tgt in zip(self.linchecks, ["A", "B", "C"],
                                [self.a_handles, self.b_handles, self.c_handles]):
            lc.attach_input_vector_row_oracles(self.w_handles)
            lc.attach_target_vector_row_oracles(tgt)
            if pr.make_zk:
                lc.attach_blinding_vector_row_oracles(self.blinding[key])
        self.rowcheck.attach_vector_row_oracles(
            self.a_handles, self.b_handles, self.c_handles)
        if pr.make_zk:
            self.rowcheck.attach_blinding_vector_row_oracles(self.blinding["row"])

    def concatenated_vector_handles(self):
        return (self.w_handles + self.a_handles + self.b_handles + self.c_handles)

    def register_linear_combinations(self):
        self.linchecks[0].register_linear_combinations()  # shared by B and C
        self.rowcheck.register_linear_combinations()

    def register_responses(self):
        for lc in self.linchecks:
            lc.register_responses()
        self.rowcheck.register_responses()

    def register_queries(self):
        positions = [self.iop.register_random_query_position(self.codeword_h)
                     for _ in range(self.params.num_queries)]
        for lc in self.linchecks:
            lc.register_queries_for_given_positions(positions)
        self.rowcheck.register_queries_for_given_positions(positions)

    # -- proving -----------------------------------------------------------
    def _supplementary_input(self, primary: List[int]) -> List[int]:
        width = self.params.matrix_width
        supp = [1] + [self.F.sample_int(int(v)) for v in primary]
        return supp + [0] * (width - len(supp))

    def _rows(self, vals: List[int], num_rows: int, width: int):
        """Host ints -> (L, num_rows, width) Montgomery limbs."""
        return self.F.from_ints(np.array(vals, dtype=object).reshape(
            num_rows, width), self.iop.device)

    def submit_witness_oracles(self, primary: List[int], auxiliary: List[int]):
        F = self.F
        pr = self.params
        h_ord = self.H.order
        z = [1] + [F.sample_int(int(v)) for v in primary] \
            + [F.sample_int(int(v)) for v in auxiliary]
        z += [0] * (pr.matrix_width - len(z))
        # w oracles carry the auxiliary-only witness (public prefix zeroed)
        aux_only = [0] * (1 + len(primary)) + [F.sample_int(int(v)) for v in auxiliary]
        aux_only += [0] * (pr.matrix_width - len(aux_only))
        w_cw = _encode_rows(F, self._rows(aux_only, pr.num_oracles_input,
                                          h_ord), self.H, self.L)
        for i, h in enumerate(self.w_handles):
            self.iop.submit_oracle(h, w_cw[:, i, :])
        z_dev = F.from_ints(z, self.iop.device)
        for M, handles in zip(self.padded,
                              [self.a_handles, self.b_handles, self.c_handles]):
            v = M.matvec(z_dev)  # (L, height)
            cw = _encode_rows(F, v.reshape(F.L, pr.num_oracles_vectors, h_ord),
                              self.H, self.L)
            for i, h in enumerate(handles):
                self.iop.submit_oracle(h, cw[:, i, :])
        if pr.make_zk:
            self._submit_blinding_oracles()

    def _submit_blinding_oracles(self):
        F = self.F
        h_ord = self.H.order
        for key in ["A", "B", "C"]:
            for h in self.blinding[key]:
                # random row summing to zero over the systematic domain
                # (uniform full-field draws: low-entropy masks would leak)
                vals = F.random_ints(h_ord - 1, self.rng)
                acc = 0
                for v in vals:
                    acc = F.add_ints(acc, v)
                vals.append((-acc) % F.p)
                cw = _encode_rows(F, self._rows(vals, 1, h_ord), self.H, self.L)
                self.iop.submit_oracle(h, cw[:, 0, :])
        for h in self.blinding["row"]:
            # vanishes on the systematic domain: random at the first
            # encoding_independence extra slots of the extended domain
            ext = self.extended
            vals = [0] * ext.order
            draws = F.random_ints(self.params.encoding_independence, self.rng)
            for off, i in enumerate(
                    range(h_ord, h_ord + self.params.encoding_independence)):
                vals[ext.reindex_by_subgroup(self.H.dim, i)] = draws[off]
            cw = _encode_rows(F, self._rows(vals, 1, ext.order), ext, self.L)
            self.iop.submit_oracle(h, cw[:, 0, :])

    def calculate_and_submit_proof(self, primary: List[int]):
        supp = self._supplementary_input(primary)
        rlcs = self.linchecks[0].all_random_linear_combinations()
        for lc in self.linchecks:
            lc.calculate_and_submit_responses(supp, rlcs)
        self.rowcheck.calculate_and_submit_responses()

    def verifier_predicate(self, primary: List[int]) -> bool:
        supp = self._supplementary_input(primary)
        rlcs = self.linchecks[0].all_random_linear_combinations()
        for lc in self.linchecks:
            if not lc.verifier_predicate(supp, rlcs):
                return False
        return self.rowcheck.verifier_predicate()


class LigeroIOPParams:
    """The reference's parameterization (ligero_iop.tcc:20-215)."""

    def __init__(self, F, security_parameter: int,
                 RS_extra_dimensions: int, height_width_ratio: float,
                 make_zk: bool, num_constraints: int, num_variables: int,
                 soundness_type: str = LDTReducerSoundnessType.optimistic_heuristic):
        self.F = F
        self.security_parameter = security_parameter
        self.RS_extra_dimensions = RS_extra_dimensions
        self.make_zk = make_zk
        num_vars = num_variables + 1
        sys_size = 1 << max(1, math.ceil(
            math.sqrt(num_vars / height_width_ratio)) - 1).bit_length()
        self.systematic_domain_dim = sys_size.bit_length() - 1
        self.codeword_domain_dim = self.systematic_domain_dim + RS_extra_dimensions
        self.num_constraints = num_constraints
        self.num_variables = num_variables
        self._set_soundness(soundness_type)

    def _set_soundness(self, soundness_type):
        F = self.F
        interactive_bits = self.security_parameter + 2
        query_bits = self.security_parameter + 2
        sys_size = 1 << self.systematic_domain_dim
        max_tested = sys_size
        self.ldt_reducer_params = LDTReducerParams(
            F, interactive_bits, soundness_type, self.codeword_domain_dim,
            max_tested, max_tested, self.make_zk)
        # matrix shape
        num_vars = self.num_variables + 1
        self.num_oracles_input = -(-num_vars // sys_size)
        matrix_width = sys_size * self.num_oracles_input
        matrix_height = self.num_constraints
        if matrix_height % sys_size:
            matrix_height += sys_size - matrix_height % sys_size
        self.num_oracles_vectors = matrix_height // sys_size
        # interactive repetitions: ceil(sec / log|F|)
        reps = max(1, math.ceil(interactive_bits / log2_field_size(F)))
        N = 1 << self.codeword_domain_dim

        def prox(query_bound):
            min_abs = (N - 2 * sys_size - 2 * query_bound + 1) // 4 - 1
            return min(self.ldt_reducer_params.absolute_proximity_parameter, min_abs)

        if not self.make_zk:
            self.query_bound = 0
            abs_prox = prox(0)
            if abs_prox < 1:
                self.RS_extra_dimensions += 1
                self.codeword_domain_dim += 1
                self._set_soundness(soundness_type)
                return
            self.direct_ldt_params = DirectLDTParams(
                query_bits, max_tested, self.RS_extra_dimensions, abs_prox)
            q_err = (2 * sys_size - 2) / N
            per_query = math.log2(q_err + abs_prox / N)
            nq = max(1, math.ceil(-query_bits / per_query))
        else:
            # the query bound is a fixed point: the encoding's queries plus
            # the direct LDT's, each depending on the bound
            estimated, last = 1, 0
            while estimated != last:
                qb = estimated + 1
                q_num = 2 * sys_size + 2 * qb - 2
                abs_prox = prox(qb)
                if q_num + 1 > N or abs_prox < 1:
                    self.RS_extra_dimensions += 1
                    self.codeword_domain_dim += 1
                    self._set_soundness(soundness_type)
                    return
                self.direct_ldt_params = DirectLDTParams(
                    query_bits, max_tested, self.RS_extra_dimensions, abs_prox)
                per_query = math.log2(q_num / N + abs_prox / N)
                nq_enc = max(1, math.ceil(-query_bits / per_query))
                estimated = last
                last = nq_enc + self.direct_ldt_params.num_queries
            nq = max(1, estimated - self.direct_ldt_params.num_queries)
            self.query_bound = estimated + 1
        self.encoded_params = EncodedLigeroParams(
            make_zk=self.make_zk, matrix_width=matrix_width,
            matrix_height=matrix_height,
            num_oracles_input=self.num_oracles_input,
            num_oracles_vectors=self.num_oracles_vectors,
            num_interactions=reps, num_queries=nq)


class LigeroIOP:
    """Interleaved R1CS + the LDT reducer hosting the direct LDT."""

    def __init__(self, iop: IOPProtocol, r1cs, params: LigeroIOPParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        F = self.F
        systematic = make_domain(F, params.systematic_domain_dim)
        extended = make_domain(F, params.systematic_domain_dim + 1)
        codeword = make_domain(
            F, params.codeword_domain_dim,
            shift=element_outside_of_subset(F, params.codeword_domain_dim))
        sh = iop.register_domain(systematic)
        eh = iop.register_domain(extended)
        self.codeword_h = iop.register_domain(codeword)
        self.protocol = InterleavedR1CS(iop, self.codeword_h, sh, eh, r1cs,
                                        params.encoded_params, rng=rng)
        self.ldt_reducer = LDTInstanceReducer(
            iop, self.codeword_h, params.ldt_reducer_params, rng=rng)

    def register_interactions(self):
        self.protocol.register_linear_combinations()
        self.protocol.register_responses()
        handles = self.protocol.concatenated_vector_handles()
        self.ldt_reducer.set_ldt(lambda iop, cwh, combined: DirectLDT(
            iop, self.params.direct_ldt_params, cwh, combined))
        self.ldt_reducer.register_interactions(handles)

    def register_queries(self):
        self.protocol.register_queries()
        self.ldt_reducer.register_queries()

    def produce_proof(self, primary: List[int], auxiliary: List[int]):
        with PROFILER.block("ligero_witness_encode"):
            self.protocol.submit_witness_oracles(primary, auxiliary)
            self.ldt_reducer.submit_masking_polynomial()
        with PROFILER.block("round0_commit"):
            self.iop.signal_prover_round_done()
        with PROFILER.block("ligero_responses"):
            self.protocol.calculate_and_submit_proof(primary)
            self.iop.signal_prover_round_done()
        with PROFILER.block("direct_ldt"):
            self.ldt_reducer.calculate_and_submit_proof()

    def verifier_predicate(self, primary: List[int]) -> bool:
        if not self.protocol.verifier_predicate(primary):
            return False
        return self.ldt_reducer.verifier_predicate()
