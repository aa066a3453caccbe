"""ctypes loader for the native OpenMP BLAKE2b: the proof-of-work solver
and the host batch hashes (leaf blocks, Merkle layers).

The port's own copy of the loader in libiop_tpu/bcs/native_blake2b.py.  It
builds native/blake2b/blake2b_batch.cpp with g++ into the port's build
directory (libiop_tpu_torch/_build/, never into native/) at first use, and
raises if the build fails.  The prover hashes its trees on the device (K3);
the host batch serves callers that hold digests as bytes.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..kernels.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "blake2b", "blake2b_batch.cpp")
_SO = os.path.join(BUILD_DIR, "libblake2b_batch.so")
_LIB = None
_LOCK = threading.Lock()

#: the longest challenge blake2b_pow_solve takes
MAX_CHALLENGE = 64


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                 "-o", tmp, _SRC], capture_output=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError("building the native BLAKE2b library failed:\n"
                                   + proc.stderr.decode(errors="replace"))
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.blake2b_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.blake2b_tree_layer.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_int]
        lib.blake2b_pow_solve.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
        lib.blake2b_pow_solve.restype = ctypes.c_uint64
        _LIB = lib
        return lib


def pow_solve(challenge: bytes, work_bits: int) -> int:
    """Smallest nonce with LE64(blake2b_8(b"pow" + challenge + LE64(nonce)))
    below 2^(64 - work_bits)."""
    if len(challenge) > MAX_CHALLENGE:
        raise ValueError(f"pow challenge longer than {MAX_CHALLENGE} bytes")
    n = _load().blake2b_pow_solve(challenge, len(challenge),
                                  1 << (64 - work_bits))
    if n == (1 << 64) - 1:
        raise RuntimeError("native pow solver found no nonce")
    return int(n)


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _tag_arg(tag: Optional[bytes]) -> int:
    return -1 if tag is None else tag[0]


def _split(raw: bytes, n: int, digest_len: int) -> List[bytes]:
    return [raw[i * digest_len:(i + 1) * digest_len] for i in range(n)]


def hash_batch(blocks: List[bytes], digest_len: int,
               tag: Optional[bytes] = None) -> Optional[List[bytes]]:
    """BLAKE2b of equal-length blocks, each prefixed by the optional 1-byte
    tag; None for no blocks or blocks of mixed lengths."""
    if not blocks:
        return None
    in_len = len(blocks[0])
    if any(len(b) != in_len for b in blocks):
        return None
    lib = _load()
    out = ctypes.create_string_buffer(len(blocks) * digest_len)
    lib.blake2b_batch(b"".join(blocks), len(blocks), in_len, out, digest_len,
                      _tag_arg(tag))
    return _split(out.raw, len(blocks), digest_len)


def hash_batch_array(arr, digest_len: int,
                     tag: Optional[bytes] = None) -> Optional[List[bytes]]:
    """BLAKE2b of the rows of an (n, in_len) uint8 array, read in place;
    None for an array that is not 2-D or has no rows."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 2 or arr.shape[0] == 0:
        return None
    n, in_len = arr.shape
    lib = _load()
    out = ctypes.create_string_buffer(n * digest_len)
    lib.blake2b_batch(arr.ctypes.data_as(ctypes.c_char_p), n, in_len, out,
                      digest_len, _tag_arg(tag))
    return _split(out.raw, n, digest_len)


def tree_layer(digests: List[bytes], digest_len: int,
               tag: Optional[bytes] = None) -> Optional[List[bytes]]:
    """[d0, d1, d2, d3, ...] -> [H(tag || d0 || d1), H(tag || d2 || d3),
    ...]; None for no digests."""
    if not digests:
        return None
    lib = _load()
    n_out = len(digests) // 2
    out = ctypes.create_string_buffer(n_out * digest_len)
    lib.blake2b_tree_layer(b"".join(digests), n_out, digest_len, out,
                           _tag_arg(tag))
    return _split(out.raw, n_out, digest_len)
