"""K3: batched tagged BLAKE2b wrapper (csrc/blake2b.cu) and its plain twin."""
from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from . import LAUNCHES, build, check_limbs, ptr, raise_on_error, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

_IV = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3]]

_QUARTERS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
             (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]

_M32 = 0xffffffff

# -- plain twin: 64-bit words in int64 tensors (adds wrap mod 2^64) ----------


def _i64(v: int) -> int:
    """A 64-bit word as the signed value an int64 tensor holds."""
    return v - (1 << 64) if v >> 63 else v


def _rotr64(x, n: int):
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _compress(h, m, t: int, last: bool):
    v = list(h) + [torch.full_like(h[0], _i64(_IV[i])) for i in range(8)]
    v[12] = v[12] ^ _i64(t)
    if last:
        v[14] = ~v[14]
    for r in range(12):
        s = _SIGMA[r]
        for k, (a, b, c, d) in enumerate(_QUARTERS):
            x, y = m[s[2 * k]], m[s[2 * k + 1]]
            va = v[a] + v[b] + x
            vd = _rotr64(v[d] ^ va, 32)
            vc = v[c] + vd
            vb = _rotr64(v[b] ^ vc, 24)
            va = va + vb + y
            vd = _rotr64(vd ^ va, 16)
            vc = vc + vd
            vb = _rotr64(vb ^ vc, 63)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2b_rows_plain(words: torch.Tensor, msg_bytes: int, digest_bytes: int,
                       tag: int) -> torch.Tensor:
    """Digests of (tag || row bytes[:msg_bytes]) for each row of words
    (n, nw) int32 (little-endian u32 words, bytes past msg_bytes zero)."""
    n, nw = words.shape
    w = words.to(torch.int64) & _M32
    # the tagged byte stream as u32 words: shift every word left by one byte
    tagged = torch.cat([
        (w[:, :1] << 8) | tag,
        ((w[:, 1:] << 8) | (w[:, :-1] >> 24)),
        w[:, -1:] >> 24], dim=1) & _M32
    total = msg_bytes + 1
    nblocks = max(1, -(-total // 128))
    if tagged.shape[1] < nblocks * 32:
        tagged = torch.cat([tagged, tagged.new_zeros(
            (n, nblocks * 32 - tagged.shape[1]))], dim=1)
    tagged = tagged[:, :nblocks * 32]       # words past the stream are 0
    words64 = tagged[:, 0::2] | (tagged[:, 1::2] << 32)
    h = [torch.full_like(words64[:, 0], _i64(_IV[i])) for i in range(8)]
    h[0] = h[0] ^ (0x01010000 ^ digest_bytes)
    for b in range(nblocks):
        m = [words64[:, 16 * b + i] for i in range(16)]
        last = b == nblocks - 1
        h = _compress(h, m, total if last else (b + 1) * 128, last)
    out = [(h[i // 2] >> (32 * (i % 2))) & _M32
           for i in range(digest_bytes // 4)]
    return torch.stack(out, dim=1).to(torch.int32)


def blake2b_rows(words: torch.Tensor, msg_bytes: int, digest_bytes: int,
                 tag: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched BLAKE2b of the tagged rows of ``words`` (n, nw) int32 into
    (n, digest_bytes // 4) int32 digest words, written to ``out`` when
    given (a contiguous tensor, e.g. a slice of a Merkle heap)."""
    check_limbs("blake2b_rows(words)", words)
    n, nw = words.shape
    if not (0 < digest_bytes <= 64 and digest_bytes % 4 == 0) \
            or not 0 <= tag < 256 or 4 * nw < msg_bytes:
        raise ValueError(f"blake2b_rows: bad arguments nw={nw} "
                         f"msg_bytes={msg_bytes} digest_bytes={digest_bytes}")
    dw = digest_bytes // 4
    if out is None:
        out = torch.empty((n, dw), dtype=torch.int32, device=words.device)
    check_limbs("blake2b_rows(out)", out, words.device)
    if tuple(out.shape) != (n, dw):
        raise ValueError(f"blake2b_rows: out shape {tuple(out.shape)}")
    if words.device.type == "cpu":
        out.copy_(blake2b_rows_plain(words, msg_bytes, digest_bytes, tag))
        return out
    fn = build.launcher("blake2b", "blake2b_rows_launch", _ARGTYPES)
    err = fn(ptr(out), ptr(words), n, nw, msg_bytes, digest_bytes, tag,
             stream_ptr(words.device))
    raise_on_error("blake2b_rows", err)
    LAUNCHES["blake2b_rows"] += 1
    return out


def merkle_heap(leaf_digests: torch.Tensor, digest_bytes: int) -> torch.Tensor:
    """(n, dw) leaf digest words -> (2n, dw) heap: heap[1] = root,
    heap[n:] = leaves, heap[0] = zeros, parent = BLAKE2b(0x01 || l || r).
    One launch per level, each writing straight into its heap slice."""
    n, dw = leaf_digests.shape
    heap = torch.zeros((2 * n, dw), dtype=torch.int32,
                       device=leaf_digests.device)
    heap[n:] = leaf_digests
    m = n
    while m > 1:
        blake2b_rows(heap[m:2 * m].reshape(m // 2, 2 * dw), 2 * digest_bytes,
                     digest_bytes, 0x01, out=heap[m // 2:m])
        m //= 2
    return heap


def digest_rows_to_bytes(rows: torch.Tensor, digest_bytes: int) -> List[bytes]:
    """Host bytes of each (dw,) digest-word row."""
    blob = rows.cpu().numpy().astype("<u4").tobytes()
    w = rows.shape[1] * 4
    return [blob[k * w:k * w + digest_bytes] for k in range(rows.shape[0])]
