"""Polynomial toolkit over multiplicative cosets: vanishing polynomials,
division by them, and blocked Horner evaluation.

Port of libiop_tpu/algebra/poly.py (multiplicative parts).  For a coset H of
order h and shift s, Z_H(x) = x^h - s^h; its evaluations over another coset
repeat with period |L|/gcd(|L|, h), so only that short cycle is computed.
Multiplication and division by Z_H run through kernel K12
(kernels/vanishing.py), evaluation (over either field family) through K10
(kernels/horner.py), the inverses through K20 (kernels/batch_inv.py) and
the Lagrange basis of H at a device point through K25 (kernels/lagrange.py).
"""
from __future__ import annotations

from math import gcd

import torch

from ..kernels.horner import horner
from ..kernels.lagrange import lagrange_coeffs
from ..kernels.vanishing import vanishing_divide, vanishing_multiply
from .domains import MultiplicativeCoset, device_powers, device_table


def _const(F, tag, H: MultiplicativeCoset, value: int, device):
    """A memoized (L, 1) device constant of H (no host copy after the
    first call)."""
    return device_table((tag, H._key()), device,
                        lambda: F.from_ints([value % F.p], device).reshape(F.L, 1))


def vanishing_eval_at_point(H: MultiplicativeCoset, x: torch.Tensor):
    """Z_H at a device point batch x (L, *batch): x^h - s^h."""
    F = H.field
    xh = F.pow_static(x, H.order)
    sh = _const(F, "shift^h", H, pow(H.shift, H.order, F.p), x.device)
    return F.sub(xh, sh.reshape((F.L,) + (1,) * (x.ndim - 1)))


def vanishing_formal_derivative_at_point(H: MultiplicativeCoset,
                                         x: torch.Tensor):
    """Z_H'(x) = h x^(h-1) at a device point batch x (L, *batch)."""
    F = H.field
    hx = F.pow_static(x, H.order - 1)
    h_l = _const(F, "order", H, H.order, x.device)
    return F.mul(hx, h_l.reshape((F.L,) + (1,) * (x.ndim - 1)))


def vanishing_coeffs_ints(H: MultiplicativeCoset):
    """Host: the coefficients (canonical ints) of Z_H = x^h - s^h."""
    coeffs = [0] * (H.order + 1)
    coeffs[0] = (-pow(H.shift, H.order, H.field.p)) % H.field.p
    coeffs[H.order] = 1
    return coeffs


def vanishing_evals_over(H: MultiplicativeCoset, L: MultiplicativeCoset,
                         device) -> torch.Tensor:
    """(limbs, |L|) evaluations of Z_H over L in natural order."""
    F = H.field
    h = H.order
    N = L.order
    distinct = N // gcd(N, h)
    w_l = F.from_ints([pow(L.g, h, F.p)], device).reshape(F.L)
    cycle = device_powers(F, w_l, max(distinct, 1))
    scale = F.from_ints([pow(L.shift, h, F.p)], device).reshape(F.L, 1)
    sh = F.from_ints([pow(H.shift, h, F.p)], device).reshape(F.L, 1)
    vals = F.sub(F.mul(cycle, scale), sh.expand(F.L, distinct))
    if distinct < N:
        vals = vals.repeat(1, N // distinct)
    return vals


def vanishing_inverse_evals_over(H: MultiplicativeCoset,
                                 L: MultiplicativeCoset, device):
    """1/Z_H over L (L disjoint from H); inverts only the short cycle (one
    K20 launch)."""
    F = H.field
    N = L.order
    distinct = N // gcd(N, H.order)
    inv = F.inv(vanishing_evals_over(H, L, device)[:, :distinct].contiguous())
    if distinct < N:
        inv = inv.repeat(1, N // distinct)
    return inv


def lagrange_poly_evals_over(H: MultiplicativeCoset, alpha: int,
                             L: MultiplicativeCoset, device) -> torch.Tensor:
    """(limbs, |L|) evaluations of the unnormalized Lagrange polynomial
    p_alpha(Y) = (Z_H(alpha) - Z_H(Y)) / (alpha - Y) over L (alpha a host
    int outside L): the division is one K20 launch, the inverse of
    alpha - Y fused with the product by the numerator."""
    F = H.field
    h = H.order
    z_alpha = (pow(alpha, h, F.p) - pow(H.shift, h, F.p)) % F.p
    z_over_L = vanishing_evals_over(H, L, device)
    num = F.sub(F.from_ints([z_alpha], device).reshape(F.L, 1).expand(
        F.L, L.order), z_over_L)
    denom = F.sub(F.from_ints([alpha % F.p], device).reshape(F.L, 1).expand(
        F.L, L.order), L.elements(device))
    return F.batch_inverse_and_mul(denom, num)


def lagrange_coefficients(H: MultiplicativeCoset,
                          alpha: torch.Tensor) -> torch.Tensor:
    """(L, h): the k-th entry is L_k(alpha), the Lagrange basis of H at the
    device element alpha ((L,) or (L, 1)); one-hot when alpha is in H.
    L_k(a) = Z_H(a) / (Z_H'(h_k) (a - h_k)) with Z_H'(h_k) = c g^-k,
    c = h s^(h-1): K25 computes zeta g^k / (a - h_k) with zeta = Z_H(a)
    c^-1, both read on the device (no host sync)."""
    F = H.field
    h = H.order
    a = alpha.reshape(F.L, 1)
    dev = a.device
    c_inv = F.inv_int(h * pow(H.shift, h - 1, F.p) % F.p)
    zeta = F.mul(vanishing_eval_at_point(H, a),
                 _const(F, "1/Z'", H, c_inv, dev))
    scal = torch.cat([a, zeta], dim=1).contiguous()
    return lagrange_coeffs(F, H.elements(dev), H.generator_powers(dev), scal)


def lagrange_poly_eval_at_point_int(H: MultiplicativeCoset, alpha: int,
                                    x: int) -> int:
    """Host-int p_alpha(x); x == alpha gives the derivative Z'_H(alpha)."""
    p = H.field.p
    alpha %= p
    x %= p
    if x == alpha:
        return H.order * pow(alpha, H.order - 1, p) % p
    z_a = (pow(alpha, H.order, p) - pow(H.shift, H.order, p)) % p
    z_x = (pow(x, H.order, p) - pow(H.shift, H.order, p)) % p
    return (z_a - z_x) * pow((alpha - x) % p, p - 2, p) % p


def mul_by_vanishing(coeffs: torch.Tensor, H: MultiplicativeCoset):
    """Coefficients of (x^h - a) * f for f given by ``coeffs`` (L, d)
    (kernel K12 on the card)."""
    F = H.field
    a = pow(H.shift, H.order, F.p)
    neg_a = F.from_ints([(F.p - a) % F.p], coeffs.device).reshape(F.L)
    return vanishing_multiply(F, coeffs.contiguous(), neg_a, H.order)


def divide_by_vanishing(coeffs: torch.Tensor, H: MultiplicativeCoset):
    """(quotient, remainder) of ``coeffs`` (L, d) by Z_H = x^h - a, widths
    d-h and h (kernel K12 on the card: synthetic division in x^h, which
    gives the reference's quotient and remainder)."""
    F = H.field
    h = H.order
    d = coeffs.shape[1]
    dev = coeffs.device
    if d <= h:
        return F.zeros((0,), dev), torch.cat(
            [coeffs, F.zeros((h - d,), dev)], dim=1)
    nb = -(-d // h)
    if d != nb * h:
        coeffs = torch.cat([coeffs, F.zeros((nb * h - d,), dev)], dim=1)
    a = F.from_ints([pow(H.shift, h, F.p)], dev).reshape(F.L)
    quotient, rem = vanishing_divide(F, coeffs.contiguous(), a, h)
    return quotient[:, :d - h].contiguous(), rem


def horner_eval(F, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial ``coeffs`` (L, d) at points x (L,) or (L, k)
    over a prime field or GF(2^k) (kernel K10 on the card).  Large degrees
    use p(x) = sum_s x^{ms} q_s(x) with m ~ sqrt(d) chunks evaluated
    together, then an S-step Horner in x^m."""
    single = x.ndim == 1
    xs = x[:, None] if single else x
    out = horner(F, coeffs.contiguous(), xs.contiguous())
    return out[:, 0] if single else out
