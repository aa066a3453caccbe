"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own ``nvcc`` process into a shared library
with a plain C interface, all sources at once, and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>.so csrc/<name>.cu

The build runs at first use into ``libiop_tpu_torch/_build/`` (listed in
.gitignore); nothing is prebuilt.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: kernel source stems; each becomes _build/<stem>.so
SOURCES = ("mont_mul", "ntt", "blake2b", "fri_fold", "field_addsub",
           "lazy_reduce", "ell_matvec", "fused_dag", "poseidon", "horner",
           "powers", "vanishing", "place_columns", "rs_encode", "row_dot",
           "gf2k_mul", "additive_fft", "linearized", "fri_fold_additive",
           "batch_inv", "p_alpha_m", "bivariate", "four_step",
           "ldt_combine", "lagrange")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: (stem, name) -> the launcher, typed once
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("libiop_tpu_torch: nvcc not found; the CUDA kernels "
                       "are built from csrc/ at first use on the GPU machine")


def _stale(stem: str) -> bool:
    so = os.path.join(BUILD_DIR, stem + ".so")
    if not os.path.exists(so):
        return True
    newest_src = max(os.path.getmtime(os.path.join(CSRC_DIR, f))
                     for f in os.listdir(CSRC_DIR))
    return os.path.getmtime(so) < newest_src


def build_all(verbose: bool = False) -> float:
    """Compile every stale kernel source in parallel; returns seconds spent."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [s for s in SOURCES if _stale(s)]
    t0 = time.time()
    if todo:
        nvcc = _nvcc()
        procs = []
        for stem in todo:
            tmp = os.path.join(BUILD_DIR, f"{stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                   os.path.join(CSRC_DIR, stem + ".cu")]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((stem, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for stem, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{stem}.cu:\n{out.decode(errors='replace')}")
            else:
                if verbose and out:
                    print(out.decode(errors="replace"))
                os.replace(tmp, os.path.join(BUILD_DIR, stem + ".so"))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.time() - t0


def launcher(stem: str, name: str, argtypes):
    """The C launcher ``name`` of kernel source ``stem`` (building all
    sources on first use), typed to return the cudaError_t as an int.  The
    first call loads and types it; later calls are one dict lookup."""
    fn = _FNS.get((stem, name))
    if fn is not None:
        return fn
    with _LOCK:
        handle = _LIBS.get(stem)
        if handle is None:
            if _stale(stem):
                build_all()
            handle = _LIBS[stem] = ctypes.CDLL(
                os.path.join(BUILD_DIR, stem + ".so"))
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(stem, name)] = fn
    return fn
