"""Nested block profiler (the port's copy of libiop_tpu/utils/profiling.py):
the same block names (``witness_encode``, ``round1_commit``, ``fri_ldt``,
...) so per-phase profiles of the two packages line up.

Device work is asynchronous, so a block's host seconds are only its own
when ``sync`` is on: every block then waits for the card at entry and exit
(set ``PROFILER.sync = True`` or ``LIBIOP_TORCH_PROFILE_SYNC=1``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch


class BlockProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sync = os.environ.get("LIBIOP_TORCH_PROFILE_SYNC") == "1"
        self._stack: List[tuple] = []
        self.records: List[tuple] = []  # (depth, name, seconds)

    def _maybe_sync(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def block(self, name: str):
        if not self.enabled:
            yield
            return
        self._maybe_sync()
        depth = len(self._stack)
        t0 = time.time()
        self._stack.append((name, t0))
        try:
            yield
        finally:
            self._maybe_sync()
            self._stack.pop()
            self.records.append((depth, name, time.time() - t0))

    def enter_block(self, name: str):
        self._stack.append((name, time.time()))

    def leave_block(self, name: str):
        nm, t0 = self._stack.pop()
        assert nm == name, (nm, name)
        self.records.append((len(self._stack), nm, time.time() - t0))

    def print_report(self):
        """The records as an indented tree, in the order blocks closed."""
        for depth, name, secs in self.records:
            print(f"{'  ' * depth}[{secs:8.3f}s] {name}")

    def report(self) -> list:
        """[(depth, name, seconds)] timing tree, JSON-serializable."""
        return list(self.records)


PROFILER = BlockProfiler()
