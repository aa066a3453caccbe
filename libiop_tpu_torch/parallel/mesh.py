"""Codeword meshes: D shards along the codeword axis.

Port of libiop_tpu/parallel/mesh.py.  JAX shards the (L, N) limb arrays over
a device mesh and lets GSPMD insert the collectives; PyTorch has no GSPMD, so
the port distributes only what is worth it, the codeword transforms: every
process and shard holder keeps full codewords, and a forward NTT over a
multiplicative coset whose order is a multiple of D^2 runs as the four-step
``ShardedNTT`` (parallel/shard_ntt.py) while a mesh is active
(``codeword_sharding_context``; algebra/fft.py routes it).  The host-side
protocol runs replicated, so the proof bytes equal the unsharded proof's.

A mesh offers ``ShardedNTT`` two collectives over its D shards, in shard
order:

- ``all_to_all(sends)``: ``sends`` holds, for each shard this process owns,
  a (D, ...) tensor whose [t] is the chunk for shard t; the result holds, for
  each owned shard, the (D, ...) tensor whose [src] came from shard src;
- ``all_gather(locals, device)``: the owned shards' tensors -> one (D, ...)
  tensor on ``device``, shard s at [s].

``make_codeword_mesh`` builds an in-process mesh: this process owns every
shard, and the collectives are tensor copies (peer copies across GPUs,
device-to-device copies on one).  ``devices=["cuda:0"] * 4`` or
``["cpu"] * 8`` puts several shards on one device, as JAX's virtual devices
do.  parallel/multihost.py builds a mesh of one shard a process over
torch.distributed.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

CODEWORD_AXIS = "cw"


class CodewordMesh:
    """An in-process mesh: shard s lives on ``devices[s]``."""

    axis = CODEWORD_AXIS

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a codeword mesh needs at least one shard")
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)

    def __repr__(self):
        return f"CodewordMesh({[str(d) for d in self.devices]})"

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(shard index, device) of each shard this process owns."""
        return list(enumerate(self.devices))

    def all_to_all(self, sends: List[torch.Tensor]) -> List[torch.Tensor]:
        D = self.size
        recvs = []
        for t, dev in self.local_shards():
            recv = torch.empty_like(sends[0], device=dev)
            for src in range(D):
                recv[src].copy_(sends[src][t])
            recvs.append(recv)
        return recvs

    def all_gather(self, local: List[torch.Tensor], device) -> torch.Tensor:
        out = torch.empty((self.size,) + tuple(local[0].shape),
                          dtype=local[0].dtype, device=device)
        for s, t in enumerate(local):
            out[s].copy_(t)
        return out


def make_codeword_mesh(n_devices: Optional[int] = None, devices=None,
                       device: str = "cuda") -> CodewordMesh:
    """A mesh of ``devices`` (one shard each, repeats allowed), or of the
    first ``n_devices`` GPUs (all of them by default) when device is
    "cuda", or ``n_devices`` shards on the CPU when device is "cpu"."""
    if devices is None:
        if torch.device(device).type == "cuda":
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("make_codeword_mesh: torch sees no GPU; "
                                   "pass devices=[...] or device='cpu'")
            n = n_devices or count
            if n > count:
                raise ValueError(f"make_codeword_mesh: {n} GPUs asked for, "
                                 f"{count} present")
            devices = [f"cuda:{i}" for i in range(n)]
        else:
            devices = [device] * (n_devices or 1)
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError("make_codeword_mesh: n_devices and devices disagree")
    return CodewordMesh(devices)


# ---------------------------------------------------------------------------
# the sharding context: while a mesh is active, algebra/fft.py runs the
# forward NTTs whose order D^2 divides as four-step ShardedNTTs over it
# ---------------------------------------------------------------------------
_ACTIVE_MESH = None


@contextlib.contextmanager
def codeword_sharding_context(mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def active_mesh():
    return _ACTIVE_MESH
