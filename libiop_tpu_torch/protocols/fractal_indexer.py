"""Fractal's matrix indexer, the holographic preprocessing of A, B, C (port
of libiop_tpu/protocols/fractal_indexer.py, both domain families).

Per matrix four index oracles over the index domain K (|K| >= nnz(M)),
low-degree extended to the codeword domain: row, col (elements of the
matrix domain H), val (the coefficient divided by the bivariate Lagrange
derivative u_H(col, col) = Z'_H(col)) and row*col.  The entries are
ordered by (row, col) as np.lexsort((cols, rows)) orders them, padded with
(H's first element, H's first element, 0, its square) up to |K|, and then
row and col are swapped (the protocol works with M' where
M'_ij = M_ji u_H(j, j)).  Over a coset the K-vectors are host code over
numpy object arrays of canonical ints; over a subspace, whose elements
come by index and whose Z' is the constant eps (one inverse), they are
gathers and K16 products on the device.  Each is computed once per matrix
(the reference computes them twice); their LDEs are one IFFT and one FFT
each on the device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..algebra.generic import (batch_inv_ints, fft_any, ifft_any,
                               is_additive,
                               vanishing_derivative_int_at_element,
                               vanishing_derivative_list)
from ..device import resolve_device
from ..iop.runtime import IOPProtocol, OracleHandle


def _elements_ints(H) -> np.ndarray:
    """The coset's elements in index order as an object array of canonical
    ints, one product an element."""
    out = np.empty(H.order, dtype=object)
    p, x = H.field.p, H.shift
    for i in range(H.order):
        out[i] = x
        x = x * H.g % p
    return out


class MatrixIndexer:
    def __init__(self, iop: IOPProtocol, index_handle, matrix_handle,
                 codeword_handle, input_variable_dim: int, matrix):
        self.iop = iop
        self.F = iop.F
        self.index_handle = index_handle
        self.K = iop.get_domain(index_handle)
        self.H = iop.get_domain(matrix_handle)
        self.L = iop.get_domain(codeword_handle)
        self.codeword_handle = codeword_handle
        self.input_variable_dim = input_variable_dim
        self.matrix = matrix
        assert self.K.order >= max(1, len(matrix.rows))

    def register_oracles(self):
        bound = self.K.order
        self.row_handle = self.iop.register_index_oracle(
            self.codeword_handle, bound)
        self.col_handle = self.iop.register_index_oracle(
            self.codeword_handle, bound)
        self.val_handle = self.iop.register_index_oracle(
            self.codeword_handle, bound)
        self.row_times_col_handle = self.iop.register_index_oracle(
            self.codeword_handle, bound)

    def get_all_oracle_handles(self) -> List[OracleHandle]:
        return [self.row_handle, self.col_handle, self.val_handle,
                self.row_times_col_handle]

    def _entries(self):
        """(order, rows, col_index): the entries in (row, col) order, their
        rows and their columns' indices in H."""
        H, M = self.H, self.matrix
        order = np.lexsort((M.cols, M.rows))
        reindex = np.array([H.reindex_by_subgroup(self.input_variable_dim, v)
                            for v in range(H.order)], dtype=np.int64)
        return order, M.rows[order], reindex[M.cols[order]]

    def vectors_over_K(self, device) -> List[torch.Tensor]:
        """The four |K|-vectors (row, col, val, row*col) on the device,
        after the row <-> col swap."""
        if not is_additive(self.H):
            return [self.F.from_ints(v, device)
                    for v in self.compute_oracles_over_K()]
        F, H = self.F, self.H
        order, rows, col_index = self._entries()
        elems = H.elements(device)
        row_elems = elems.index_select(1, torch.from_numpy(rows).to(device))
        col_elems = elems.index_select(
            1, torch.from_numpy(col_index).to(device))
        coeffs = torch.from_numpy(np.ascontiguousarray(
            self.matrix.vals[:, order])).to(device)
        # Z'_H is the constant eps over a subspace: one inverse
        deriv_inv = F.inv_int(vanishing_derivative_int_at_element(H, 0))
        pad_n = self.K.order - len(order)
        pad = elems[:, :1].expand(F.W, pad_n)

        def padded(v, fill):
            return torch.cat([v, fill], dim=1).contiguous()

        row_evals = padded(row_elems, pad)
        col_evals = padded(col_elems, pad)
        val_evals = padded(F.mul(coeffs, F.scalar(deriv_inv, coeffs)),
                           F.zeros((pad_n,), device))
        rc_evals = F.mul(row_evals, col_evals)
        # transpose: swap row and col (val is already indexed for M')
        return [col_evals, row_evals, val_evals, rc_evals]

    def compute_oracles_over_K(self) -> List[np.ndarray]:
        """The four |K|-vectors (row, col, val, row*col) over a coset as
        object arrays of canonical ints, after the row <-> col swap."""
        F, H, M = self.F, self.H, self.matrix
        order, rows, col_index = self._entries()
        coeffs = F.to_ints(torch.from_numpy(
            np.ascontiguousarray(M.vals[:, order])))
        elems = _elements_ints(H)
        deriv_inv = np.array(batch_inv_ints(F, vanishing_derivative_list(H)),
                             dtype=object)
        row_elems, col_elems = elems[rows], elems[col_index]
        nnz, k = len(order), self.K.order
        row_evals = np.empty(k, dtype=object)
        col_evals = np.empty(k, dtype=object)
        val_evals = np.zeros(k, dtype=object)
        rc_evals = np.empty(k, dtype=object)
        pad = elems[0]
        row_evals[:] = pad
        col_evals[:] = pad
        rc_evals[:] = F.mul_ints(pad, pad)
        row_evals[:nnz] = row_elems
        col_evals[:nnz] = col_elems
        val_evals[:nnz] = coeffs * deriv_inv[col_index] % F.p
        rc_evals[:nnz] = row_elems * col_elems % F.p
        # transpose: swap row and col (val is already indexed for M')
        return [col_evals, row_evals, val_evals, rc_evals]

    def compute_oracles(self, device="cuda") -> List[torch.Tensor]:
        """LDE the four K-vectors to the codeword domain and submit them
        (fractal_indexer.tcc:126-150); returns the K-vectors (the
        lincheck's index inputs)."""
        vectors = self.vectors_over_K(resolve_device(device))
        self.submit_oracles(vectors)
        return vectors

    def submit_oracles(self, vectors: List[torch.Tensor]):
        """LDE each K-vector (device tensors) to the codeword domain and
        submit it."""
        for vec, handle in zip(vectors, self.get_all_oracle_handles()):
            self.iop.submit_oracle(handle, fft_any(ifft_any(vec, self.K),
                                                   self.L))
