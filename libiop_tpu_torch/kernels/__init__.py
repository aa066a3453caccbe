"""Python wrappers of the hand-written CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, launches its kernel
for CUDA tensors (raising if the build, the launch or cudaGetLastError
fails) and runs the plain PyTorch twin beside it only for CPU tensors.
``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

LAUNCHES = {"mont_mul": 0, "ntt_stage": 0, "blake2b_rows": 0, "fri_fold": 0,
            "field_addsub": 0, "lazy_reduce": 0, "ell_matvec": 0,
            "fused_dag": 0, "poseidon": 0, "horner": 0, "powers": 0,
            "vanishing": 0, "place_columns": 0, "rs_encode": 0, "row_dot": 0,
            "gf2k_mul": 0, "additive_fft": 0, "linearized": 0,
            "fri_fold_additive": 0, "batch_inv": 0, "p_alpha_m": 0,
            "ell_matvec_gf2": 0, "horner_gf2": 0, "powers_gf2": 0,
            "p_alpha_m_gf2": 0, "bivariate": 0, "bivariate_gf2": 0,
            "four_step_prologue": 0, "four_step_twiddle": 0,
            "four_step_unpack": 0, "four_step_epilogue": 0,
            "ldt_combine": 0, "ldt_combine_gf2": 0, "lagrange_coeffs": 0,
            "lagrange_coeffs_gf2": 0}

#: 32-bit words per field element that the field kernels are instantiated
#: for (csrc/field.cuh): 6 for edwards_Fr (L = 12), 8 for alt_bn128_Fr (16)
KERNEL_WORDS = (6, 8)
#: 32-bit words per element that the binary-field kernels are instantiated
#: for (csrc/gf2k.cuh): gf64, gf128, gf192, gf256
BINARY_WORDS = (2, 4, 6, 8)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def field_words(F) -> int:
    """The word count W = L/2 a field kernel is launched with for field F;
    raises for a limb count no kernel is instantiated for."""
    if F.L % 2 or F.L // 2 not in KERNEL_WORDS:
        raise ValueError(f"{F.name}: {F.L} limbs; the CUDA field kernels are "
                         f"built for {[2 * w for w in KERNEL_WORDS]} limbs")
    return F.L // 2


def binary_words(F) -> int:
    """The word count W a binary-field kernel is launched with for F."""
    if F.W not in BINARY_WORDS:
        raise ValueError(f"{F.name}: {F.W} words; the binary-field kernels "
                         f"are built for {list(BINARY_WORDS)} words")
    return F.W


def check_limbs(name: str, t: torch.Tensor, device: torch.device = None):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 limbs, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")


def host_words(F, values) -> np.ndarray:
    """Host ints as a kernel's 32-bit words, W a value: the Montgomery form
    x R mod p over a prime field, the canonical bits over GF(2^k)."""
    if F.kind == "additive":
        W, vals = F.W, values
    else:
        W, vals = F.L // 2, [v * F.R % F.p for v in values]
    return np.array([(v >> (32 * j)) & 0xffffffff
                     for v in vals for j in range(W)], dtype=np.uint32)


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, passed as is to a launcher whose argtypes
    declare it c_void_p (no ctypes object built a call)."""
    return t.data_ptr()


#: the raw cudaStream_t of the current stream, without building a
#: torch.cuda.Stream (absent from builds without CUDA)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` as an address for a launcher."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def raise_on_error(kernel: str, err: int):
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")


def _index_map(op_batch, out_batch):
    """(div, mod) with op element = (i // div) % mod for flat output index
    i, or None when the operand's broadcast is not one contiguous block."""
    nb = len(out_batch)
    op = (1,) * (nb - len(op_batch)) + tuple(op_batch)
    live = [k for k in range(nb) if op[k] != 1]
    if not live:
        return 1, 1
    lo, hi = live[0], live[-1]
    if any(op[k] != out_batch[k] for k in range(lo, hi + 1)):
        return None
    return math.prod(out_batch[hi + 1:]), math.prod(out_batch[lo:hi + 1])


def broadcast_operand(t, out_batch):
    """The operand as K1/K5 read it: (tensor, (div, mod)) with element
    (i // div) % mod for flat output index i; a broadcast that is not one
    contiguous block is materialized."""
    m = _index_map(t.shape[1:], out_batch)
    if m is None:  # not a block broadcast: materialize it
        t = t.expand((t.shape[0],) + tuple(out_batch)).contiguous()
        m = (1, math.prod(out_batch))
    return t, m
