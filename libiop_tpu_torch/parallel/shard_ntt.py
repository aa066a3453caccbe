"""Distributed NTT: the four-step (Bailey) decomposition over a codeword mesh.

Port of libiop_tpu/parallel/shard_ntt.py.  N = R * C with the input viewed
as x[j1 + R * j2] -> grid [j2, j1] and the mesh sharding the j1 axis:

  1. C-point sub-NTTs along j2    - shard-local, over the local j1 columns
  2. twiddle multiply w^(j1 * k2) - shard-local elementwise
  3. all-to-all: reshard j1 -> k2 - the ONE collective of the transform
  4. R-point sub-NTTs along j1    - shard-local

then an all-gather of the (k2, k1) shards, so that every process holds the
natural-order codeword X[k1 * C + k2].  The sub-NTTs are K2's stages over
bit-reversed rows (``algebra.fft._butterfly_stages``); the passes between
them (gather with the shift and bit reversal, twiddle and pack, unpack,
placement) are kernel K23 (kernels/four_step.py).
"""
from __future__ import annotations

import math

import torch

from ..algebra.domains import MultiplicativeCoset
from ..algebra.fft import _butterfly_stages
from ..kernels import four_step


class ShardedNTT:
    """Plans a four-step NTT of size N = 2^dim over ``mesh``'s D shards."""

    def __init__(self, domain: MultiplicativeCoset, mesh):
        F = domain.field
        self.F = F
        self.domain = domain
        self.mesh = mesh
        self.D = D = mesh.size
        N = domain.order
        logN = domain.dim
        logR = logN // 2
        # R must be divisible by D (the j1 axis is sharded)
        while (1 << logR) % D:
            logR += 1
        self.R = 1 << logR
        self.C = N >> logR
        if self.R % D or self.C < 1 or self.C % D:
            raise ValueError(f"ShardedNTT: N = 2^{logN} does not split over "
                             f"{D} shards (R = {self.R}, C = {self.C})")
        g = domain.g
        # sub-domains: the C-point NTT uses g^R, the R-point one g^C (no
        # shifts: the coset shift is folded into the coefficients up front)
        self.dom_C = MultiplicativeCoset(F, logN - logR, 1,
                                         pow(g, self.R, F.p))
        self.dom_R = MultiplicativeCoset(F, logR, 1, pow(g, self.C, F.p))

    def __call__(self, coeffs: torch.Tensor) -> torch.Tensor:
        """coeffs: (L, *batch, d), d <= N, natural order (zero-padded to N);
        returns the natural-order codeword (L, *batch, N) on coeffs' device,
        computed with a single all-to-all across the mesh."""
        F, D, R, C = self.F, self.D, self.R, self.C
        N = self.domain.order
        lead = tuple(coeffs.shape[1:-1])
        d = coeffs.shape[-1]
        if coeffs.shape[0] != F.L or d > N:
            raise ValueError(f"ShardedNTT: coefficients {tuple(coeffs.shape)}"
                             f" over a domain of {N}")
        x = coeffs.reshape(F.L, math.prod(lead), d).contiguous()
        shift = self.domain.shift != 1
        sends = []
        for s, dev in self.mesh.local_shards():
            a = four_step.prologue(
                F, x.to(dev), s, D, R, C,
                self.domain.shift_powers(dev) if shift else None)
            a = _butterfly_stages(F, a, self.dom_C.generator_powers(dev), C, 1)
            sends.append(four_step.twiddle_pack(
                F, a, s, D, self.domain.generator_powers(dev)))
        recvs = self.mesh.all_to_all(sends)
        del sends
        local = []
        for (s, dev), recv in zip(self.mesh.local_shards(), recvs):
            c = four_step.unpack(F, recv, R)
            local.append(_butterfly_stages(
                F, c, self.dom_R.generator_powers(dev), R, 1))
        del recvs
        gathered = self.mesh.all_gather(local, coeffs.device)
        return four_step.epilogue(F, gathered, C).reshape(
            (F.L,) + lead + (N,))
