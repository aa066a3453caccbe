"""Sparse matrices with field-element values and a gather-based matvec.

Port of libiop_tpu/relations/sparse.py.  The COO structure is host numpy;
``matvec`` pads every segment to the maximum degree K (a static ELL plan,
built once and kept on the device) and runs kernel K7 over it
(kernels/ell_matvec.py).  When padding would exceed 4x nnz it falls back to
a segment sum (``index_add_``) reduced once (K1 products, K6 reduction);
over GF(2^k) to the CSR walk of kernel K21 (kernels/p_alpha_m.py) with
one matrix, r = 1 and the identity placement.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ell_matvec import ell_matvec
from ..kernels.p_alpha_m import p_alpha_m

#: lazily summed terms per row stay far inside int64; the cap mirrors the
#: reference's so the same systems are accepted
MAX_ROW_NNZ = 1 << 12


class SparseMatrix:
    """COO sparse matrix; values are (L, nnz) Montgomery limbs (numpy)."""

    def __init__(self, F, num_rows: int, num_cols: int,
                 rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        self.F = F
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        assert self.rows.shape == self.cols.shape
        self.vals = np.asarray(vals, dtype=np.int32).reshape(F.L, -1)
        if len(self.rows):
            assert np.bincount(self.rows, minlength=num_rows).max() \
                <= MAX_ROW_NNZ, "row too dense for lazy accumulation"
            assert np.bincount(self.cols, minlength=num_cols).max() \
                <= MAX_ROW_NNZ, "col too dense for lazy accumulation"
        self._plans = {}
        self._dev_cache = {}

    @property
    def num_nonzero(self) -> int:
        return len(self.rows)

    @classmethod
    def from_entries(cls, F, num_rows: int, num_cols: int, entries):
        """entries: list of (row, col, int_value)."""
        rows = np.array([e[0] for e in entries], dtype=np.int64)
        cols = np.array([e[1] for e in entries], dtype=np.int64)
        vals = F.from_ints_np([e[2] for e in entries]) if entries else \
            np.zeros((F.L, 0), np.int32)
        return cls(F, num_rows, num_cols, rows, cols, vals)

    def _dev(self, name, device, compute):
        key = (name, str(device))
        t = self._dev_cache.get(key)
        if t is None:
            t = self._dev_cache[key] = torch.from_numpy(
                np.ascontiguousarray(compute())).to(device)
        return t

    def _vals_pad(self, device):
        """The values with the zero column padding slots point at."""
        return self._dev("vals_pad", device, lambda: np.concatenate(
            [self.vals, np.zeros((self.F.L, 1), np.int32)], axis=1))

    @staticmethod
    def _ell_plan(seg_ids: np.ndarray, src_ids: np.ndarray, num_segments: int):
        """(entry_idx (S*K,), src_flat (S*K,), K) with sentinel entries at an
        appended zero value, or None when K*S > 4*nnz + 4096."""
        nnz = len(seg_ids)
        counts = np.bincount(seg_ids, minlength=num_segments)
        K = int(counts.max(initial=1))
        if K * num_segments > 4 * nnz + 4096:
            return None
        order = np.argsort(seg_ids, kind="stable")
        sseg = seg_ids[order]
        starts = np.zeros(num_segments + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        flat_pos = sseg * K + (np.arange(nnz, dtype=np.int64) - starts[sseg])
        entry_idx = np.full(num_segments * K, nnz, dtype=np.int64)
        entry_idx[flat_pos] = order
        src_flat = np.zeros(num_segments * K, dtype=np.int64)
        src_flat[flat_pos] = src_ids[order]
        return entry_idx, src_flat, K

    def _apply(self, tag, seg_ids, src_ids, num_segments, vec, force_segsum):
        F = self.F
        dev = vec.device
        plan = None
        if not force_segsum:
            if tag not in self._plans:
                self._plans[tag] = self._ell_plan(seg_ids, src_ids, num_segments)
            plan = self._plans[tag]
        if plan is not None:
            entry_idx, src_flat, K = plan
            vals_pad = self._vals_pad(dev)
            e_dev = self._dev(tag + "_entry", dev, lambda: entry_idx)
            s_dev = self._dev(tag + "_src", dev, lambda: src_flat)
            return ell_matvec(F, vals_pad, e_dev, s_dev, vec.contiguous(), K)
        if F.kind == "additive":
            ident = self._dev(tag + "_ident", dev,
                              lambda: np.arange(num_segments, dtype=np.int64))
            return p_alpha_m(F, [self._csr_device(tag, seg_ids, src_ids,
                                                  num_segments, dev)],
                             vec.contiguous(), [1], ident, num_segments)
        vals = self._dev("vals", dev, lambda: self.vals)
        src = self._dev(tag + "_src_coo", dev, lambda: src_ids)
        seg = self._dev(tag + "_seg_coo", dev, lambda: seg_ids)
        prod = F.mul(vals, vec.index_select(1, src))
        return F.segment_reduce(prod, seg, num_segments)

    def matvec(self, z, force_segsum: bool = False):
        """M @ z for z (L, num_cols) Montgomery -> (L, num_rows)."""
        return self._apply("mv", self.rows, self.cols, self.num_rows, z,
                           force_segsum)

    def _csr_device(self, tag, seg_ids, src_ids, num_segments, device):
        """The matrix grouped by segment on the device, (vals, offsets, src,
        kmax): segment j's nonzeros are vals[:, offsets[j]:offsets[j + 1]]
        in entry order, src their indices into the vector, kmax the densest
        segment's count.  No padding (kernel K21 reads it)."""
        key = tag + "_csr"
        if key not in self._plans:
            counts = np.bincount(seg_ids, minlength=num_segments)
            offsets = np.zeros(num_segments + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            order = np.argsort(seg_ids, kind="stable")
            self._plans[key] = (self.vals[:, order], offsets, src_ids[order],
                                int(counts.max(initial=0)))
        vals, offsets, src, kmax = self._plans[key]
        return (self._dev(key + "_vals", device, lambda: vals),
                self._dev(key + "_offsets", device, lambda: offsets),
                self._dev(key + "_src", device, lambda: src), kmax)

    def transpose_csr_device(self, device):
        """M^T in CSR form on the device, (vals, offsets, src, kmax): column
        j's nonzeros in row order, src their rows (kernel K21's plan)."""
        return self._csr_device("mvT", self.cols, self.rows, self.num_cols,
                                device)

    def matvec_transpose(self, y, force_segsum: bool = False):
        """M^T @ y for y (L, num_rows) -> (L, num_cols)."""
        return self._apply("mvT", self.cols, self.rows, self.num_cols, y,
                           force_segsum)
