"""ctypes loader for the native OpenMP BLAKE2b proof-of-work solver.

The port's own copy of the loader in libiop_tpu/bcs/native_blake2b.py.  It
builds native/blake2b/blake2b_batch.cpp with g++ into the port's build
directory (libiop_tpu_torch/_build/, never into native/) at first use, and
raises if the build fails.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

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
