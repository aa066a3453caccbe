"""Domain-generic algebra surface over both domain families.

Port of libiop_tpu/algebra/generic.py: the call surface the protocols use
(domains, FFTs, vanishing polynomials, column placement, host-int Lagrange
helpers, the unnormalized Lagrange polynomial p_alpha), dispatching
between multiplicative cosets of prime fields and affine subspaces of
binary fields (``is_additive``).
"""
from __future__ import annotations

import hashlib
import weakref
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import place_columns as _k13
from ..kernels.lagrange import lagrange_coeffs
from ..kernels.linearized import linearized_multiply
from . import poly as mpoly
from .domains import MultiplicativeCoset, device_table, host_powers
from .fft import fft, ifft, ifft_of_known_degree
from .linearized import LinearizedVanishing, divide_by_linearized
from .subspace import AffineSubspace, additive_fft, additive_ifft


def is_additive(domain) -> bool:
    return domain.kind == "affine_subspace"


def make_domain(F, dim: int, shift=None):
    """The canonical domain of dimension dim over F (a subgroup, or the
    standard-basis subspace), optionally shifted."""
    if F.kind == "additive":
        return AffineSubspace(F, dim, shift=shift or 0)
    return MultiplicativeCoset(F, dim, shift=1 if shift is None else shift)


def element_outside_of_subset(F, dim: int) -> int:
    """An element outside the canonical domain of dimension dim, the
    codeword domain's shift: x^dim for a subspace, the multiplicative
    generator for a subgroup."""
    if F.kind == "additive":
        return 1 << dim
    return F.multiplicative_generator


def linearized_vanishing(H: AffineSubspace) -> LinearizedVanishing:
    """The memoized LinearizedVanishing of an affine subspace."""
    z = getattr(H, "_linearized_vanishing", None)
    if z is None:
        z = H._linearized_vanishing = LinearizedVanishing(H)
    return z


def fft_any(coeffs, domain):
    if is_additive(domain):
        return additive_fft(coeffs, domain)
    return fft(coeffs, domain)


def ifft_any(evals, domain):
    if is_additive(domain):
        return additive_ifft(evals, domain)
    return ifft(evals, domain)


def ifft_known_any(evals, domain, degree_bound: int):
    """IFFT of a polynomial of known degree bound over its minimal
    subdomain: the additive prefix subspace occupies the first d slots."""
    if is_additive(domain):
        d = 1 << (max(1, degree_bound) - 1).bit_length()
        if d >= domain.order:
            return additive_ifft(evals, domain)
        return additive_ifft(evals[..., :d].contiguous(),
                             domain.get_subset_of_order(d))
    return ifft_of_known_degree(evals, domain, degree_bound)


def vanishing_eval_int(H, x: int) -> int:
    """Z_H(x) as a host int."""
    if is_additive(H):
        return linearized_vanishing(H).eval_at_point_int(x)
    F = H.field
    return F.sub_ints(F.pow_int(x, H.order), F.pow_int(H.shift, H.order))


def vanishing_derivative_int(H, x: int) -> int:
    """Z_H'(x) at any point: h x^(h-1) over a coset; the constant eps over
    a subspace."""
    F = H.field
    if is_additive(H):
        return linearized_vanishing(H).epsilon
    return F.mul_ints(H.order % F.p, F.pow_int(x, H.order - 1))


#: id of a read-only positions array -> (a weak reference to it, the key of
#: its contents)
_FROZEN_POSITIONS: dict = {}
#: host work of place_columns: contents keyed (copied and digested) and
#: inverse maps built
PLACEMENT_STATS = {"keys": 0, "maps": 0}


def _positions_key(positions):
    """The key of the positions' contents.  A read-only numpy array (the
    IOP objects freeze theirs) is digested at its first call and found by
    identity afterwards, so a call costs the host O(1); any other sequence
    is copied and digested at every call."""
    frozen = isinstance(positions, np.ndarray) and \
        not positions.flags.writeable
    if frozen:
        hit = _FROZEN_POSITIONS.get(id(positions))
        if hit is not None and hit[0]() is positions:
            return hit[1]
    PLACEMENT_STATS["keys"] += 1
    arr = np.ascontiguousarray(positions, dtype=np.int64)
    key = (arr.shape, hashlib.blake2b(arr.tobytes(), digest_size=16).digest())
    if frozen:
        i = id(positions)
        _FROZEN_POSITIONS[i] = (weakref.ref(
            positions, lambda _, i=i: _FROZEN_POSITIONS.pop(i, None)), key)
    return key


def place_columns(values: torch.Tensor, positions, out_size: int):
    """out[..., positions[k]] = values[..., k], zeros elsewhere, as a gather
    through the memoized int32 inverse placement, whose sentinel nv marks
    a zero column (kernel K13 on the card)."""
    nv = values.shape[-1]

    def _inverse():
        PLACEMENT_STATS["maps"] += 1
        inv = np.full(out_size, nv, dtype=np.int32)
        inv[np.asarray(positions, dtype=np.int64)] = np.arange(
            nv, dtype=np.int32)
        return inv

    inv = device_table(("place", out_size, nv, _positions_key(positions)),
                       values.device, _inverse)
    return _k13.place_columns(values.contiguous(), inv)


def vanishing_evals_over_any(H, L, device):
    """(limbs, |L|) evaluations of Z_H over L (memoized per device)."""
    if is_additive(H):
        return linearized_vanishing(H).evals_over(L, device)
    return device_table(("z", H._key(), L._key()), device,
                        lambda: mpoly.vanishing_evals_over(H, L, device))


def vanishing_inverse_evals_over_any(H, L, device):
    """1/Z_H over L (L disjoint from H; memoized per device).  A binary
    field inverts the evaluation table through K16."""
    if is_additive(H):
        return device_table(
            ("zinv", H._key(), L._key()), device,
            lambda: H.field.inv(vanishing_evals_over_any(H, L, device)))
    return device_table(
        ("zinv", H._key(), L._key()), device,
        lambda: mpoly.vanishing_inverse_evals_over(H, L, device))


def mul_by_vanishing_any(coeffs, H):
    """Coefficients of Z_H * f (kernel K12, or K18 for a subspace)."""
    if is_additive(H):
        return linearized_multiply(
            H.field, coeffs.contiguous(),
            linearized_vanishing(H).coeffs_dense_positions(), H.order)
    return mpoly.mul_by_vanishing(coeffs, H)


def divide_by_vanishing_any(coeffs, H):
    """(quotient, remainder) of a dense coefficient array by Z_H."""
    if is_additive(H):
        return divide_by_linearized(H.field, coeffs, linearized_vanishing(H))
    return mpoly.divide_by_vanishing(coeffs, H)


def lagrange_coefficients_any(domain, alpha_int: int, device="cuda"):
    """(limbs, h) device Lagrange basis of ``domain`` at a host-int point:
    L_k(alpha) = Z(alpha) / (Z'(e_k) (alpha - e_k)), the one-hot vector when
    alpha is in the domain.  One K25 launch over the memoized element (and,
    for a coset, generator-power) tables: zeta g^k / (alpha - e_k) with
    zeta = Z(alpha) (h s^(h-1))^-1 over a coset, zeta / (alpha - e_k) with
    zeta = Z(alpha) eps^-1 over a subspace."""
    F = domain.field
    dev = resolve_device(device)
    h = domain.order
    alpha = F.sample_int(alpha_int)
    if is_additive(domain):
        c, ws = linearized_vanishing(domain).epsilon, None
    else:
        c = F.mul_ints(h % F.p, F.pow_int(domain.shift, h - 1))
        ws = domain.generator_powers(dev)
    zeta = F.mul_ints(vanishing_eval_int(domain, alpha), F.inv_int(c))
    scal = F.from_ints([alpha, zeta], dev)
    return lagrange_coeffs(F, domain.elements(dev), ws, scal)


def host_powers_any(F, x_int: int, n: int, start: int = 1) -> np.ndarray:
    """[start * x^k, k < n] as a (limbs, n) numpy array over either field
    (domains.host_powers takes both)."""
    return host_powers(F, x_int, n, start=start)


def horner_eval_ints(F, coeffs: List[int], x: int) -> int:
    """Host-int Horner evaluation with field-generic ops."""
    acc = 0
    for c in reversed(coeffs):
        acc = F.add_ints(F.mul_ints(acc, x), c)
    return acc


def lagrange_coeffs_ints_any(domain, x: int) -> List[int]:
    """Host-int Lagrange coefficients of a small domain at x:
    L_k(x) = Z(x) / (Z'(e_k) (x - e_k)), memoized per (domain, x)."""
    cache = getattr(domain, "_lagrange_cache", None)
    if cache is None:
        cache = domain._lagrange_cache = {}
    hit = cache.get(x)
    if hit is not None:
        return hit
    F = domain.field
    h = domain.order
    elems = [domain.element_by_index_int(i) for i in range(h)]
    for i, e in enumerate(elems):
        if e == x:
            out = [1 if j == i else 0 for j in range(h)]
            cache[x] = out
            return out
    z_x = vanishing_eval_int(domain, x)
    zps = vanishing_derivative_list(domain)
    denoms = [F.mul_ints(zps[i], F.sub_ints(x, e)) for i, e in enumerate(elems)]
    out = [F.mul_ints(z_x, v) for v in batch_inv_ints(F, denoms)]
    cache[x] = out
    return out


def batch_inv_ints(F, vals: List[int]) -> List[int]:
    """Montgomery's trick: n inversions for one modular inverse + 3n muls."""
    n = len(vals)
    prefix = [1] * n
    acc = 1
    for i, v in enumerate(vals):
        prefix[i] = acc
        acc = F.mul_ints(acc, v)
    inv = F.inv_int(acc)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = F.mul_ints(inv, prefix[i])
        inv = F.mul_ints(inv, vals[i])
    return out


def vanishing_derivative_list(domain) -> List[int]:
    """[Z'(e_i)]: the constant eps over a subspace, h s^{h-1} g^{-i} over a
    coset; memoized per domain."""
    hit = getattr(domain, "_zprime_list", None)
    if hit is not None:
        return hit
    h = domain.order
    if is_additive(domain):
        out = domain._zprime_list = [linearized_vanishing(domain).epsilon] * h
        return out
    F = domain.field
    c = F.mul_ints(h % F.p, F.pow_int(domain.shift, h - 1))
    g_inv = F.inv_int(domain.g)
    out = []
    for _ in range(h):
        out.append(c)
        c = F.mul_ints(c, g_inv)
    domain._zprime_list = out
    return out


def vanishing_derivative_int_at_element(domain, index: int) -> int:
    """Z'(e_index) for e_index the index-th domain element."""
    return vanishing_derivative_list(domain)[index]


# -- the succinct (unnormalized) Lagrange polynomial of a domain H at alpha:
# p_alpha(Y) = (Z_H(alpha) - Z_H(Y)) / (alpha - Y), both families ----------
def lagrange_poly_evals_over_any(H, alpha: int, L, device) -> torch.Tensor:
    """(limbs, |L|) evaluations of p_alpha over L (alpha outside L): one
    K20 launch over a coset; over a subspace the numerator is an XOR of
    memoized Z_H tables and the division a K16 inverse and product."""
    if not is_additive(H):
        return mpoly.lagrange_poly_evals_over(H, alpha, L, device)
    F = H.field
    z_over_L = vanishing_evals_over_any(H, L, device)
    num = F.add(z_over_L, F.scalar(vanishing_eval_int(H, alpha), z_over_L))
    elems = L.elements(device)
    denom = F.sub(elems, F.scalar(alpha, elems))
    return F.batch_inverse_and_mul(denom, num)


def lagrange_poly_eval_at_point_int_any(H, alpha: int, x: int) -> int:
    """Host-int p_alpha(x); x == alpha gives the derivative Z'_H(alpha)
    (the constant eps over a subspace)."""
    if not is_additive(H):
        return mpoly.lagrange_poly_eval_at_point_int(H, alpha, x)
    F = H.field
    if x == alpha:
        return linearized_vanishing(H).formal_derivative()
    return F.mul_ints(F.sub_ints(vanishing_eval_int(H, alpha),
                                 vanishing_eval_int(H, x)),
                      F.inv_int(F.sub_ints(alpha, x)))
