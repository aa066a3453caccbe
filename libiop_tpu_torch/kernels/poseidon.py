"""K9: batched Poseidon sponge wrapper (csrc/poseidon.cu) and its plain twin.

K9 hashes n items at once, each a sponge over k field elements: the
elements are added into state[0:rate] in rate-sized chunks with a
permutation between chunks, one final permutation, and state[0] is the
digest.  A Merkle leaf is the sponge over its column of elements (zk: the
salt element appended); a tree node is the sponge over (left, right),
which equals the reference's two-to-one (state[0..1] SET from zero, one
permutation) for every rate >= 2.  ``poseidon_merkle_heap`` launches K9
once for the leaves and once per tree level into a (L, 2n) heap whose
column 1 is the root, the layout K3's BLAKE2b heap has row-wise.

The constants (``bp``, a bcs.poseidon.BatchedPoseidon) are the round keys
and MDS matrix in Montgomery form; the kernel keeps them in constant
memory and uploads them again only when the parameter set changes.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, build, check_limbs, field_words, ptr, raise_on_error,
               stream_ptr)
from ..fields.limbs import _antidiag, _toeplitz, carry, cond_sub_p

#: limits of the constant block (csrc/poseidon.cu PoseidonConsts)
MAX_T, MAX_ROUNDS = 4, 160

_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + \
    [ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]


def pack_consts(bp):
    """The PoseidonConsts block of csrc/poseidon.cu as uint32 words: t,
    rate, alpha, full and partial rounds, near_mds, then the round keys
    (round r, lane i at element r*t + i) and the MDS matrix (row i, column
    j at element i*t + j), each element W Montgomery words, padded to the
    block's fixed size."""
    F = bp.F
    W = F.L // 2
    rounds = bp.full_rounds + bp.partial_rounds
    if not 2 <= bp.t <= MAX_T or rounds > MAX_ROUNDS or bp.rate >= bp.t:
        raise ValueError(f"poseidon: t={bp.t} rate={bp.rate} rounds={rounds} "
                         f"exceed K9's limits (t <= {MAX_T}, rounds <= "
                         f"{MAX_ROUNDS})")

    def words(values, size):
        out = []
        for v in values:
            m = (v % F.p) * F.R % F.p
            out += [(m >> (32 * j)) & 0xffffffff for j in range(W)]
        return out + [0] * (size * W - len(out))

    rc = [v for row in bp.rc_ints for v in row]
    mds = [v for row in bp.mds_ints for v in row] if bp.mds_ints else []
    block = [bp.t, bp.rate, bp.alpha, bp.full_rounds, bp.partial_rounds,
             int(bp.near_mds)] + words(rc, MAX_ROUNDS * MAX_T) \
        + words(mds, MAX_T * MAX_T)
    return (ctypes.c_uint32 * len(block))(*block)


# -- plain twin ---------------------------------------------------------------
#
# The twin runs every permutation in a Montgomery domain of one extra 16-bit
# limb, R' = 2^(16(L+1)), on int64 digit rows that are never carried to
# canonical form inside a sponge: a product is the product columns (float64,
# exact) and one REDC whose carries are fixed passes, with no loop.  With
# p < R' / 2^18 a REDC of inputs below 16p returns a value below 2.1p with
# digits below 2^17.1, so the adds of a round (round key, absorbed element)
# need no reduction, and the partial rounds, many times more than the full
# ones, cost a few dozen torch calls each.  Elements enter by a product with
# R'^2 / R and leave by a product with R (then two conditional subtractions):
# the results are the canonical Montgomery (R) values the kernel gives.

_MASK = (1 << 16) - 1


def _spread(t: torch.Tensor) -> torch.Tensor:
    """One carry pass over int64 digit rows t (K, n), each below 2^46: bits
    16-31 of a row move one row up and the bits above two rows up (those
    past the last row are dropped: the value mod 2^(16K), which is the
    value itself when it is below 2^(16K)), leaving every row below
    2^17 + 2^14."""
    out = t & _MASK
    out[1:] += (t[:-1] >> 16) & _MASK
    out[2:] += t[:-2] >> 32
    return out


class _Domain:
    """Constants of the twin's R' domain for one field on one device."""

    def __init__(self, F, device):
        L = self.L = F.L + 1
        Rp = 1 << (16 * L)
        assert F.p * (1 << 18) < Rp
        self.F = F
        self.Rp = Rp
        # n' = -p^-1 mod R' times T mod R', T's digits split at bit 22: the
        # high parts weigh 2^6 in the next digit (mod R')
        n_mat = _toeplitz((-pow(F.p, -1, Rp)) % Rp, L, L, device)
        n_hi = torch.zeros_like(n_mat)
        n_hi[:, :-1] = 64 * n_mat[:, 1:]
        self.n_mat = torch.cat([n_mat, n_hi], dim=1)
        self.p_mat = _toeplitz(F.p, L, 2 * L, device)
        self.carry_in = torch.tensor([[2.0 ** -48, 2.0 ** -32, 2.0 ** -16]],
                                     dtype=torch.float64, device=device)
        self.enter = self.digits([Rp * Rp * pow(F.R, -1, F.p) % F.p], device)
        self.leave = self.digits([F.R % F.p], device)

    def digits(self, values, device) -> torch.Tensor:
        """(L', len(values)) int64 digit rows of the ints ``values``."""
        return torch.tensor([[(v >> (16 * j)) & _MASK for v in values]
                             for j in range(self.L)], dtype=torch.int64,
                            device=device)

    def mont(self, v: int) -> int:
        return v % self.F.p * self.Rp % self.F.p

    def redc(self, T: torch.Tensor) -> torch.Tensor:
        """T * R'^-1 (mod p) for product columns T (2L', *batch), each
        below 2^42 and value(T) below 32 p^2: (L', *batch) digit rows
        below 2^17.1, value below T / R' + 2.01 p.  m = (T mod R') n' is
        left unreduced below 2.01 R' (float64 products, exact below 2^53);
        U = T + m p is a multiple of R', and its low half carries
        value(U_low) / R' into the top half, an integer that the top three
        low rows give to within 2^-22 (float64 rounds it exactly); the
        top half's value, below 2.1p < R', is spread over L' rows."""
        L = self.L
        batch = tuple(T.shape[1:])
        T = T.reshape(2 * L, -1)
        low = T[:L]
        split = torch.cat([low & ((1 << 22) - 1), low >> 22])
        m = _spread((self.n_mat @ split.to(torch.float64)).to(torch.int64))
        U = T + (self.p_mat @ m.to(torch.float64)).to(torch.int64)
        q = torch.round(self.carry_in @ U[L - 3:L].to(torch.float64))
        U[L] += q[0].to(torch.int64)
        return _spread(U[L:]).reshape((L,) + batch)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.redc(_antidiag(a, b, 2 * self.L))

    def to_domain(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical Montgomery (R) limbs (L, *batch) -> R' digit rows."""
        x = torch.cat([x.to(torch.int64),
                       x.new_zeros((1,) + tuple(x.shape[1:]),
                                   dtype=torch.int64)])
        e = self.enter.reshape((self.L,) + (1,) * (x.ndim - 1))
        return self.mul(x, e)

    def from_domain(self, x: torch.Tensor) -> torch.Tensor:
        """R' digit rows (value below 16p) -> canonical Montgomery (R)
        limbs (L, *batch) int32."""
        F = self.F
        e = self.leave.reshape((self.L,) + (1,) * (x.ndim - 1))
        v = carry(self.mul(x, e))              # below 2.1p, normalized
        return cond_sub_p(F, cond_sub_p(F, v).to(torch.int64))


def _domain(bp, device) -> "_Domain":
    key = ("poseidon_twin", str(device))
    hit = bp.F._dev_consts.get(key)
    if hit is None:
        hit = bp.F._dev_consts[key] = _Domain(bp.F, device)
    return hit


def _twin_consts(bp, device):
    """(domain, round keys (rounds, L', t, 1) R' digit rows, the MDS
    matrix (2L' t, L' t) float64 whose product with the state's (L' t, n)
    rows gives every output lane's product columns, row 2L' x digit +
    lane): the near-MDS forms are the 0/1 matrices [[1,0,1],[1,1,0],
    [0,1,1]] and (J - I), as MDS matrices."""
    key = str(device)
    hit = bp._twin.get(key)
    if hit is None:
        D = _domain(bp, device)
        t = bp.t
        rc = D.digits([D.mont(v) for row in bp.rc_ints for v in row], device)
        rc = rc.reshape(D.L, -1, t).permute(1, 0, 2).unsqueeze(-1)
        if bp.mds_ints is not None:
            mds = bp.mds_ints
        elif t == 3:
            mds = [[1, 0, 1], [1, 1, 0], [0, 1, 1]]
        else:
            mds = [[int(i != j) for j in range(t)] for i in range(t)]
        mat = torch.zeros((2 * D.L, t, D.L, t), dtype=torch.float64,
                          device=device)
        for i, row in enumerate(mds):
            for j, v in enumerate(row):
                mat[:, i, :, j] = _toeplitz(D.mont(v), D.L, 2 * D.L, device)
        hit = bp._twin[key] = (D, rc.contiguous(),
                               mat.reshape(2 * D.L * t, D.L * t))
    return hit


def _sbox(D, x: torch.Tensor, alpha: int) -> torch.Tensor:
    """x^alpha by square-and-multiply over the bits of alpha."""
    acc = x
    for bit in bin(alpha)[3:]:
        acc = D.mul(acc, acc)
        if bit == "1":
            acc = D.mul(acc, x)
    return acc


def _permute(bp, s: torch.Tensor, consts) -> torch.Tensor:
    """The permutation of every state in (L', t, n) R' digit rows."""
    D, rc, mat = consts
    t, half = bp.t, bp.full_rounds // 2
    L = D.L
    for r in range(bp.full_rounds + bp.partial_rounds):
        s = s + rc[r]
        if half <= r < half + bp.partial_rounds:
            s = torch.cat([s[:, :t - 1], _sbox(D, s[:, t - 1:], bp.alpha)],
                          dim=1)
        else:
            s = _sbox(D, s, bp.alpha)
        T = mat @ s.reshape(L * t, -1).to(torch.float64)
        s = D.redc(T.to(torch.int64).reshape(2 * L, t, -1))
    return s


def poseidon_permute_plain(bp, state: torch.Tensor) -> torch.Tensor:
    """The permutation of every state in (L, t, n)."""
    consts = _twin_consts(bp, state.device)
    D = consts[0]
    return D.from_domain(_permute(bp, D.to_domain(state), consts))


def poseidon_sponge_plain(bp, elems: torch.Tensor) -> torch.Tensor:
    """(L, k, n) elements -> (L, n) digests: rate-sized chunks added into
    state[0:rate] with a permutation between chunks, a final permutation,
    state[0] (the reference's BatchedPoseidon.hash_columns)."""
    consts = _twin_consts(bp, elems.device)
    D = consts[0]
    _, k, n = elems.shape
    x = D.to_domain(elems)
    s = x.new_zeros((D.L, bp.t, n))
    for start in range(0, k, bp.rate):
        if start:
            s = _permute(bp, s, consts)
        chunk = x[:, start:start + bp.rate]
        w = chunk.shape[1]
        s = torch.cat([s[:, :w] + chunk, s[:, w:]], dim=1)
    return D.from_domain(_permute(bp, s, consts)[:, 0])


def poseidon_merkle_heap_plain(bp, elems: torch.Tensor) -> torch.Tensor:
    """The heap of poseidon_merkle_heap: the leaf sponges, then each level
    as the sponge over its (left, right) pairs."""
    F = bp.F
    n = elems.shape[2]
    heap = torch.zeros((F.L, 2 * n), dtype=torch.int32, device=elems.device)
    heap[:, n:] = poseidon_sponge_plain(bp, elems)
    return _levels_plain(bp, heap)


def _levels_plain(bp, heap: torch.Tensor) -> torch.Tensor:
    m = heap.shape[1] // 2
    while m > 1:
        pairs = torch.stack([heap[:, m:2 * m:2], heap[:, m + 1:2 * m:2]], dim=1)
        heap[:, m // 2:m] = poseidon_sponge_plain(bp, pairs)
        m //= 2
    return heap


# -- kernel wrapper -----------------------------------------------------------

def _launch(bp, out, out_off: int, src, src_off: int, estride: int,
            istride: int, n: int, k: int):
    """K9 over n items: item i's element e is column src_off + e*estride +
    i*istride of src (L, cols); its digest goes to column out_off + i of
    out (L, cols)."""
    F = bp.F
    fn = build.launcher("poseidon", "poseidon_launch", _ARGTYPES)
    err = fn(ptr(out), out.shape[1], out_off, ptr(src), src.shape[1], src_off,
             estride, istride, n, k, bp.kernel_words(), bp.key,
             field_words(F), F.kernel_params(), stream_ptr(out.device))
    raise_on_error("poseidon", err)
    LAUNCHES["poseidon"] += 1


def _check(bp, elems: torch.Tensor):
    check_limbs("poseidon(elems)", elems)
    if elems.ndim != 3 or elems.shape[0] != bp.F.L or elems.shape[1] < 1:
        raise ValueError(f"poseidon: expected ({bp.F.L}, k >= 1, n) elements, "
                         f"got {tuple(elems.shape)}")


def poseidon_hash_columns(bp, elems: torch.Tensor) -> torch.Tensor:
    """(L, k, n) Montgomery elements -> (L, n) sponge digests.  CUDA
    tensors launch K9; CPU tensors run the plain twin."""
    _check(bp, elems)
    if elems.device.type == "cpu":
        return poseidon_sponge_plain(bp, elems)
    _, k, n = elems.shape
    out = torch.empty((bp.F.L, n), dtype=torch.int32, device=elems.device)
    if n:
        _launch(bp, out, 0, elems.reshape(bp.F.L, k * n), 0, n, 1, n, k)
    return out


def poseidon_merkle_heap(bp, elems: torch.Tensor) -> torch.Tensor:
    """(L, k, n) leaf elements (n a power of two) -> (L, 2n) heap of
    Montgomery digests: column 1 the root, n..2n-1 the leaves, column 0
    zero, parent m = two_to_one(2m, 2m+1).  CUDA tensors launch K9 once for
    the leaves and once per level; CPU tensors run the plain twin."""
    _check(bp, elems)
    F = bp.F
    _, k, n = elems.shape
    if n & (n - 1):
        raise ValueError(f"poseidon_merkle_heap: {n} leaves, not a power of 2")
    if elems.device.type == "cpu":
        return poseidon_merkle_heap_plain(bp, elems)
    heap = torch.zeros((F.L, 2 * n), dtype=torch.int32, device=elems.device)
    _launch(bp, heap, n, elems.reshape(F.L, k * n), 0, n, 1, n, k)
    return poseidon_merkle_levels(bp, heap)


def poseidon_merkle_levels(bp, heap: torch.Tensor) -> torch.Tensor:
    """Fill, in place, the levels above the leaves heap[:, n:] of a (L, 2n)
    heap: parent m = two_to_one(2m, 2m+1).  CUDA tensors launch K9 once per
    level; CPU tensors run the plain twin."""
    check_limbs("poseidon_merkle_levels(heap)", heap)
    if heap.device.type == "cpu":
        return _levels_plain(bp, heap)
    m = heap.shape[1] // 2
    while m > 1:
        _launch(bp, heap, m // 2, heap, m, 1, 2, m // 2, 2)
        m //= 2
    return heap
