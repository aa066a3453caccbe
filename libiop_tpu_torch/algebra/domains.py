"""Multiplicative cosets: evaluation domains of the multiplicative branch.

Port of libiop_tpu/algebra/domains.py.  Elements are enumerated in natural
power order (shift * g^k); a size-c coset inside a domain of size N sits at
the strided positions j + i*(N/c).  Index arithmetic is host int math; power
tables are built on the device by kernel K11 (kernels/powers.py) and
memoized per device (``device_table``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fields.prime import PrimeField
from ..kernels.powers import powers

_DEVICE_TABLES: dict = {}
_DEVICE_TABLES_BYTES = [0]
_DEVICE_TABLES_CAP = 4 << 30


def device_table(key, device, compute) -> torch.Tensor:
    """Device copy of a derived table, memoized by (key, device).  ``compute``
    returns a numpy array or a tensor; byte-bounded FIFO eviction."""
    full = (key, str(device))
    out = _DEVICE_TABLES.get(full)
    if out is None:
        val = compute()
        out = (torch.from_numpy(np.ascontiguousarray(val)) if isinstance(
            val, np.ndarray) else val).to(device).contiguous()
        nbytes = out.numel() * out.element_size()
        while _DEVICE_TABLES and \
                _DEVICE_TABLES_BYTES[0] + nbytes > _DEVICE_TABLES_CAP:
            old = _DEVICE_TABLES.pop(next(iter(_DEVICE_TABLES)))
            _DEVICE_TABLES_BYTES[0] -= old.numel() * old.element_size()
        _DEVICE_TABLES[full] = out
        _DEVICE_TABLES_BYTES[0] += nbytes
    return out


def clear_device_tables():
    """Drop every memoized device table (they are rebuilt on next use)."""
    _DEVICE_TABLES.clear()
    _DEVICE_TABLES_BYTES[0] = 0


def host_powers(F, x_int: int, n: int, start: int = 1) -> np.ndarray:
    """[start * x^k, k < n] as a (limbs, n) numpy array computed with host
    ints (Montgomery limbs over a prime field, words over GF(2^k))."""
    acc, out = F.sample_int(start), []
    for _ in range(n):
        out.append(acc)
        acc = F.mul_ints(acc, x_int)
    return F.from_ints_np(out)


def device_powers(F, x: torch.Tensor, n: int) -> torch.Tensor:
    """[x^0, ..., x^(n-1)] as (L, n) for a device element x (L,), over a
    prime field or GF(2^k) (kernel K11 on the card)."""
    return powers(F, x.contiguous(), n)


def bitrev_permutation(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class MultiplicativeCoset:
    """The coset shift * <g> of order 2^dim (shift and g canonical ints)."""

    kind = "multiplicative_coset"

    def __init__(self, field: PrimeField, dim: int, shift: int = 1,
                 generator: Optional[int] = None):
        assert dim <= field.two_adicity, (
            f"domain dim {dim} exceeds 2-adicity {field.two_adicity}")
        self.field = field
        self.dim = dim
        self.order = 1 << dim
        self.shift = shift % field.p
        if generator is None:
            generator = pow(field.root_of_unity,
                            1 << (field.two_adicity - dim), field.p)
        self.g = generator

    def _key(self):
        return (self.field.name, self.dim, self.shift, self.g)

    def __eq__(self, other):
        return isinstance(other, MultiplicativeCoset) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"MultCoset(dim={self.dim}, shift={self.shift % 997}..., field={self.field.name})"

    def num_elements(self) -> int:
        return self.order

    # -- power tables, built on the device (K11) and memoized per device ----
    def _table(self, tag, x_int, start, device):
        F = self.field

        def compute():
            x, s = F.from_ints([x_int % F.p, start % F.p], device).T
            return powers(F, x.contiguous(), self.order, s.contiguous())

        return device_table((tag, self._key()), device, compute)

    def generator_powers(self, device):
        """(L, order) g^k (Montgomery) on ``device``."""
        return self._table("gpow", self.g, 1, device)

    def inverse_generator_powers(self, device):
        return self._table("ginv", pow(self.g, self.field.p - 2, self.field.p),
                           1, device)

    def shift_powers(self, device):
        return self._table("spow", self.shift, 1, device)

    def inverse_shift_powers(self, device):
        return self._table("sinv", pow(self.shift, self.field.p - 2,
                                       self.field.p), 1, device)

    def elements(self, device):
        """(L, order) shift * g^k (Montgomery) on ``device``."""
        return self._table("elem", self.g, self.shift, device)

    def inverse_elements(self, device):
        F = self.field
        return self._table("einv", pow(self.g, F.p - 2, F.p),
                           pow(self.shift, F.p - 2, F.p), device)

    def element_by_index_int(self, index: int) -> int:
        return (self.shift * pow(self.g, index, self.field.p)) % self.field.p

    # -- index arithmetic (reference subgroup.tcc:147-198) -----------------
    def reindex_by_subgroup(self, subgroup_dim: int, index: int) -> int:
        order_s = 1 << subgroup_dim
        order_g_over_s = 1 << (self.dim - subgroup_dim)
        if index < order_s:
            return index * order_g_over_s
        i = index - order_s
        x = order_g_over_s - 1
        return i + (i // x) + 1

    def coset_index(self, position: int, coset_size: int) -> int:
        return position % (self.order // coset_size)

    def intra_coset_index(self, position: int, coset_size: int) -> int:
        return position // (self.order // coset_size)

    def position_by_coset_indices(self, coset_index: int,
                                  intra_coset_index: int, coset_size: int) -> int:
        return coset_index + intra_coset_index * (self.order // coset_size)

    def get_subset_of_order(self, order: int) -> "MultiplicativeCoset":
        assert order <= self.order and (order & (order - 1)) == 0
        dim = order.bit_length() - 1
        g_sub = pow(self.g, self.order // order, self.field.p)
        return MultiplicativeCoset(self.field, dim, self.shift, g_sub)

    def unshifted_subgroup(self) -> "MultiplicativeCoset":
        return MultiplicativeCoset(self.field, self.dim, 1, self.g)
