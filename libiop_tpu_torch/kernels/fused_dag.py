"""K8: fused virtual-oracle DAG wrapper (csrc/fused_dag.cu), the tape
compiler it runs, and its plain twin.

A DAG of elementwise field expressions (the ``traced_contents`` of the
virtual oracles under a set of roots, iop/runtime.py) is recorded with a
``TapeRecorder``, which stands in for the PrimeField (``add``, ``sub``,
``mul`` on symbolic values), and compiled into a straight-line ``Tape``:
packed instruction words over a small register file, input codewords
(L, n) and broadcast scalars.  The card evaluates the whole tape in one
launch; the plain twin interprets the same words with the plain field ops.
Over a binary field the same tape runs through K8's GF(2^k) instantiation
(add and sub are XOR).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from . import (LAUNCHES, binary_words, build, check_limbs, field_words,
               raise_on_error, stream_ptr)
from ..fields.limbs import add_plain, mul_plain, sub_plain
from .gf2k_mul import gf2k_mul_plain

# limits of the kernel's launch parameters (csrc/fused_dag.cu)
MAX_INPUTS, MAX_OUTPUTS, MAX_SCALARS, MAX_OPS, MAX_REGS = 32, 4, 48, 192, 16
#: scalar stride in the launch parameters (fp::kMaxWords)
MAX_WORDS = 8

ADD, SUB, MUL, STORE = 0, 1, 2, 3
REG, INPUT, SCALAR = 0, 1, 2


class DagLimitError(ValueError):
    """A DAG that does not fit the kernel's launch parameters."""


class _DagParams(ctypes.Structure):
    _fields_ = [("inputs", ctypes.c_void_p * MAX_INPUTS),
                ("outputs", ctypes.c_void_p * MAX_OUTPUTS),
                ("scalars", ctypes.c_uint32 * (MAX_SCALARS * MAX_WORDS)),
                ("ops", ctypes.c_uint32 * MAX_OPS),
                ("n_ops", ctypes.c_int),
                ("n", ctypes.c_longlong)]


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _binary(F) -> bool:
    return F.kind == "additive"


@dataclasses.dataclass(frozen=True)
class TapeValue:
    """A symbolic field value: an input codeword, a scalar, or the result
    of the tape's op number ``index`` (kind REG)."""
    kind: int
    index: int


@dataclasses.dataclass(frozen=True)
class Tape:
    """Packed instruction words (see csrc/fused_dag.cu) and the counts of
    inputs, scalars, outputs and registers they use."""
    ops: Tuple[int, ...]
    n_inputs: int
    n_scalars: int
    n_outputs: int
    n_regs: int

    def count(self, op: int) -> int:
        return sum(1 for w in self.ops if w & 3 == op)


class TapeRecorder:
    """Records field ops on symbolic values (SSA) and compiles them."""

    def __init__(self):
        self.n_inputs = 0
        self.n_scalars = 0
        self.ssa: List[Tuple[int, TapeValue, TapeValue]] = []

    def input(self) -> TapeValue:
        self.n_inputs += 1
        return TapeValue(INPUT, self.n_inputs - 1)

    def scalar(self) -> TapeValue:
        self.n_scalars += 1
        return TapeValue(SCALAR, self.n_scalars - 1)

    def _op(self, op: int, a: TapeValue, b: TapeValue) -> TapeValue:
        self.ssa.append((op, a, b))
        return TapeValue(REG, len(self.ssa) - 1)

    def add(self, a, b):
        return self._op(ADD, a, b)

    def sub(self, a, b):
        return self._op(SUB, a, b)

    def mul(self, a, b):
        return self._op(MUL, a, b)

    def finish(self, roots: Sequence[TapeValue]) -> Tape:
        """Allocate registers by liveness and emit one store per root."""
        n = len(self.ssa)
        last = {}
        for k, (_, a, b) in enumerate(self.ssa):
            for v in (a, b):
                if v.kind == REG:
                    last[v.index] = k
        for r in roots:
            if r.kind == REG:
                last[r.index] = n
        free = list(range(MAX_REGS - 1, -1, -1))
        where = {}
        words = []
        peak = 0

        def enc(v: TapeValue) -> int:
            return v.kind << 10 | (where[v.index] if v.kind == REG else v.index)

        for k, (op, a, b) in enumerate(self.ssa):
            ea, eb = enc(a), enc(b)
            for v in {a, b}:
                if v.kind == REG and last[v.index] == k:
                    free.append(where.pop(v.index))
            if not free:
                raise DagLimitError(f"fused DAG needs more than {MAX_REGS} "
                                 "live values (the kernel's register file)")
            dst = free.pop()
            peak = max(peak, MAX_REGS - len(free))
            if k in last:
                where[k] = dst
            else:  # dead value
                free.append(dst)
            words.append(op | dst << 2 | ea << 8 | eb << 20)
        for o, r in enumerate(roots):
            words.append(STORE | o << 2 | enc(r) << 8)
        if len(words) > MAX_OPS or self.n_inputs > MAX_INPUTS \
                or self.n_scalars > MAX_SCALARS or len(roots) > MAX_OUTPUTS:
            raise DagLimitError(
                f"fused DAG exceeds the kernel's limits: {len(words)} ops "
                f"(max {MAX_OPS}), {self.n_inputs} inputs (max {MAX_INPUTS}), "
                f"{self.n_scalars} scalars (max {MAX_SCALARS}), {len(roots)} "
                f"roots (max {MAX_OUTPUTS})")
        return Tape(tuple(words), self.n_inputs, self.n_scalars, len(roots),
                    peak)


def fused_dag_plain(F, tape: Tape, inputs: Sequence[torch.Tensor],
                    scalars: Sequence[int]) -> List[torch.Tensor]:
    """Interpret the tape's words with the plain field ops."""
    dev = inputs[0].device
    n = inputs[0].shape[1]
    sc = F.from_ints(list(scalars), dev) if scalars else None
    regs: List[torch.Tensor] = [None] * MAX_REGS
    outs: List[torch.Tensor] = [None] * tape.n_outputs
    if _binary(F):
        add = sub = lambda F, a, b: torch.bitwise_xor(a, b)
        mul = gf2k_mul_plain
    else:
        add, sub, mul = add_plain, sub_plain, mul_plain

    def fetch(o: int) -> torch.Tensor:
        kind, idx = o >> 10, o & 1023
        if kind == INPUT:
            return inputs[idx]
        if kind == SCALAR:
            return sc[:, idx:idx + 1]
        return regs[idx]

    for w in tape.ops:
        op, dst = w & 3, (w >> 2) & 63
        a = fetch((w >> 8) & 0xfff)
        if op == STORE:
            outs[dst] = a.expand(F.L, n).contiguous()
            continue
        b = fetch(w >> 20)
        if op == ADD:
            regs[dst] = add(F, a, b)
        elif op == SUB:
            regs[dst] = sub(F, a, b)
        else:
            regs[dst] = mul(F, a, b)
    return outs


def fused_dag(F, tape: Tape, inputs: Sequence[torch.Tensor],
              scalars: Sequence[int]) -> List[torch.Tensor]:
    """Evaluate ``tape`` at every position of the (L, n) input codewords;
    ``scalars`` are canonical field ints broadcast to every position.
    Returns the tape's n_outputs (L, n) codewords.  CUDA tensors launch K8
    (one launch); CPU tensors run the plain twin."""
    if not inputs or len(inputs) != tape.n_inputs \
            or len(scalars) != tape.n_scalars:
        raise ValueError(f"fused_dag: the tape takes {tape.n_inputs} inputs "
                         f"and {tape.n_scalars} scalars, got {len(inputs)} "
                         f"and {len(scalars)}")
    dev = inputs[0].device
    n = inputs[0].shape[1]
    for k, t in enumerate(inputs):
        check_limbs(f"fused_dag(input {k})", t, dev)
        if tuple(t.shape) != (F.L, n):
            raise ValueError(f"fused_dag: input {k} has shape "
                             f"{tuple(t.shape)}, expected {(F.L, n)}")
    if dev.type == "cpu":
        return fused_dag_plain(F, tape, inputs, scalars)
    outs = [torch.empty((F.L, n), dtype=torch.int32, device=dev)
            for _ in range(tape.n_outputs)]
    prm = _DagParams()
    for k, t in enumerate(inputs):
        prm.inputs[k] = t.data_ptr()
    for k, t in enumerate(outs):
        prm.outputs[k] = t.data_ptr()
    binary = _binary(F)
    for k, v in enumerate(scalars):
        m = F.sample_int(int(v)) if binary else (int(v) % F.p) * F.R % F.p
        for j in range(F.W if binary else F.L // 2):
            prm.scalars[k * MAX_WORDS + j] = (m >> (32 * j)) & 0xffffffff
    for k, w in enumerate(tape.ops):
        prm.ops[k] = w
    prm.n_ops = len(tape.ops)
    prm.n = n
    if binary:
        fn = build.launcher("fused_dag", "fused_dag_gf2_launch", _ARGTYPES)
        err = fn(ctypes.byref(prm), binary_words(F), F.kernel_params(),
                 stream_ptr(dev))
    else:
        fn = build.launcher("fused_dag", "fused_dag_launch", _ARGTYPES)
        err = fn(ctypes.byref(prm), field_words(F), F.kernel_params(),
                 stream_ptr(dev))
    raise_on_error("fused_dag", err)
    LAUNCHES["fused_dag"] += 1
    return outs
