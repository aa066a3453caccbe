"""Radix-2 NTT over multiplicative cosets.

Port of libiop_tpu/algebra/fft.py (``_fft_impl`` / ``_ifft_impl`` /
``ifft_of_known_degree``): natural-order evaluations in and out, iterative
decimation in time over bit-reversed input, degree-aware (a polynomial with
d <= N coefficients starts at stage m = N/d after duplicating each
coefficient N/d times).  The butterfly stages are kernel K2, at most two
multi-stage passes a transform; the glue (bit reversal, duplication, shift
and 1/N scaling with K1) is PyTorch.

Data is (L, *batch, N) Montgomery limbs.

While a codeword mesh is active (parallel/mesh.py), a forward transform of
order N that D^2 divides runs as the four-step ShardedNTT over the mesh's D
shards, its coefficients zero-padded to N; every other transform (inverse
ones, N < D^2) runs locally.  ``SHARD_ROUTES`` counts the route each
transform under a mesh took.
"""
from __future__ import annotations

import torch

from ..kernels.ntt import ntt_stages
from ..parallel.mesh import active_mesh
from .domains import MultiplicativeCoset, bitrev_permutation, device_table

#: the routes of the transforms run under an active mesh: the four-step
#: ShardedNTT, or local
SHARD_ROUTES = {"four_step": 0, "local": 0}


def _bcast(w, ndim):
    """Reshape (L, m) to broadcast over (L, *batch, m)."""
    return w.reshape((w.shape[0],) + (1,) * (ndim - 2) + (w.shape[1],))


def _bitrev_index(n: int, device) -> torch.Tensor:
    return device_table(("bitrev", n), device,
                        lambda: torch.from_numpy(bitrev_permutation(n)))


def _butterfly_stages(F, x, W, N: int, first_m: int):
    """Stages m = first_m, 2*first_m, ..., N/2 over x (L, *batch, N)."""
    lead = x.shape[:-1]
    x = ntt_stages(F, x.reshape(F.L, -1, N).contiguous(), W, first_m)
    return x.reshape(lead + (N,))


def fft(coeffs: torch.Tensor, domain: MultiplicativeCoset) -> torch.Tensor:
    """Evaluate (L, *batch, d) coefficient arrays over ``domain`` (order
    N >= d); returns (L, *batch, N) natural-order evaluations."""
    F = domain.field
    N = domain.order
    mesh = active_mesh()
    if mesh is not None:
        if N % (mesh.size * mesh.size) == 0:
            SHARD_ROUTES["four_step"] += 1
            from ..parallel.shard_ntt import ShardedNTT
            return ShardedNTT(domain, mesh)(coeffs)
        SHARD_ROUTES["local"] += 1
    dev = coeffs.device
    d = coeffs.shape[-1]
    if d & (d - 1):
        d2 = 1 << d.bit_length()
        coeffs = torch.cat([coeffs, coeffs.new_zeros(
            coeffs.shape[:-1] + (d2 - d,))], dim=-1)
        d = d2
    assert d <= N, (d, N)
    if domain.shift != 1:
        sp = domain.shift_powers(dev)[:, :d]
        coeffs = F.mul(coeffs, _bcast(sp, coeffs.ndim))
    if d == 1:
        return coeffs[..., :1].expand(coeffs.shape[:-1] + (N,)).contiguous()
    x = coeffs.index_select(-1, _bitrev_index(d, dev))
    if N > d:
        x = torch.repeat_interleave(x, N // d, dim=-1)
    return _butterfly_stages(F, x, domain.generator_powers(dev), N,
                             first_m=N // d)


def ifft(evals: torch.Tensor, domain: MultiplicativeCoset) -> torch.Tensor:
    """Interpolate (L, *batch, N) natural-order evaluations -> coefficients."""
    F = domain.field
    N = domain.order
    dev = evals.device
    assert evals.shape[-1] == N
    if active_mesh() is not None:
        SHARD_ROUTES["local"] += 1
    if N == 1:
        return evals
    x = evals.index_select(-1, _bitrev_index(N, dev))
    x = _butterfly_stages(F, x, domain.inverse_generator_powers(dev), N,
                          first_m=1)
    x = F.mul(x, F.scalar(pow(N, F.p - 2, F.p), x))
    if domain.shift != 1:
        x = F.mul(x, _bcast(domain.inverse_shift_powers(dev)[:, :N], x.ndim))
    return x


def ifft_of_known_degree(evals, domain: MultiplicativeCoset,
                         degree_bound: int):
    """IFFT of a polynomial known to have < degree_bound coefficients:
    interpolate over the minimal subdomain (strided positions)."""
    N = domain.order
    d = max(1, degree_bound)
    d = 1 << (d - 1).bit_length()
    assert d <= N
    if d == N:
        return ifft(evals, domain)
    sub = domain.get_subset_of_order(d)
    return ifft(evals[..., ::N // d].contiguous(), sub)


def naive_fft_ints(coeff_ints, domain: MultiplicativeCoset):
    """Host reference evaluation by Horner (canonical ints)."""
    p = domain.field.p
    out = []
    for k in range(domain.order):
        x = domain.element_by_index_int(k)
        acc = 0
        for c in reversed(coeff_ints):
            acc = (acc * x + int(c)) % p
        out.append(acc)
    return out
