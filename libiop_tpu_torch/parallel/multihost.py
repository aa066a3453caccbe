"""Several processes, one codeword mesh: torch.distributed.

Port of libiop_tpu/parallel/multihost.py.  One process a shard (a rank of
the process group), every process running the SAME host-side protocol code
(registration, hashchain and transcript assembly are deterministic and
replicated), with full codewords on every rank.  The forward NTTs of a
proof proven under ``codeword_sharding_context(make_global_codeword_mesh())``
run as four-step ShardedNTTs whose all-to-all and all-gather cross the
processes, so every rank ends with identical bytes: the multi-process
analogue of the single-vs-sharded proof identity, checked with
``assert_same_on_all_processes``.

Backends: ``nccl`` for CUDA (one GPU a rank), ``gloo`` for the CPU.  The
choice is never switched silently: two ranks that share one GPU must pass
``backend="gloo"`` (NCCL refuses two ranks on one device); gloo then takes
the CUDA tensors of ``all_to_all_single`` and ``all_gather_into_tensor``
itself, staging them through the host.
"""
from __future__ import annotations

from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import CODEWORD_AXIS

_DEVICE: Optional[torch.device] = None

# all_gather_into_tensor was renamed all_gather_single in later torch
_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def initialize(init_method: str, world_size: int, rank: int,
               backend: Optional[str] = None, device="cuda",
               timeout: timedelta = timedelta(seconds=60)) -> None:
    """Join the process group.  Call once per process, before any proof.
    ``init_method`` is a rendezvous (``tcp://localhost:<port>`` or
    ``file:///<path>``); ``device`` is this rank's device ("cuda:<i>" or
    "cpu"); ``backend`` defaults to nccl for a CUDA device and gloo for the
    CPU."""
    global _DEVICE
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    _DEVICE = dev


def shutdown() -> None:
    """Leave the process group."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _comm_device() -> torch.device:
    """Where host bytes go for a collective: the CPU under gloo, this rank's
    GPU under nccl."""
    return _DEVICE if dist.get_backend() == "nccl" else torch.device("cpu")


class GlobalCodewordMesh:
    """One shard a rank, in rank order; collectives over the process
    group."""

    axis = CODEWORD_AXIS

    def __init__(self, device: torch.device):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = device

    def __repr__(self):
        return (f"GlobalCodewordMesh(rank {self.rank} of {self.size} on "
                f"{self.device}, {dist.get_backend()})")

    def local_shards(self):
        return [(self.rank, self.device)]

    def all_to_all(self, sends: List[torch.Tensor]) -> List[torch.Tensor]:
        send = sends[0].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return [recv]

    def all_gather(self, local: List[torch.Tensor], device) -> torch.Tensor:
        t = local[0].contiguous()
        out = torch.empty((self.size * t.numel(),), dtype=t.dtype,
                          device=t.device)
        _all_gather_flat(out, t.reshape(-1))
        return out.reshape((self.size,) + tuple(t.shape)).to(device)


def make_global_codeword_mesh() -> GlobalCodewordMesh:
    """The mesh of every rank of the process group (``initialize`` first)."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_codeword_mesh: call initialize first")
    return GlobalCodewordMesh(_DEVICE or torch.device("cpu"))


class GlobalCodeword:
    """A codeword sharded along its trailing axis over a global mesh: this
    rank's contiguous chunk (``local``), the mesh, and the global shape."""

    def __init__(self, mesh: GlobalCodewordMesh, local: torch.Tensor):
        self.mesh = mesh
        self.local = local
        self.shape = tuple(local.shape[:-1]) + (local.shape[-1] * mesh.size,)

    def full(self) -> torch.Tensor:
        """The whole codeword on this rank (an all-gather)."""
        g = self.mesh.all_gather([self.local], self.local.device)
        return g.movedim(0, -2).reshape(self.shape)


def host_local_to_global(mesh: GlobalCodewordMesh, local_shard
                         ) -> GlobalCodeword:
    """This rank's chunk of the trailing axis (rank order) -> one logical
    codeword; kernels run on ``.local``."""
    if isinstance(local_shard, np.ndarray):
        local_shard = torch.from_numpy(np.ascontiguousarray(local_shard))
    return GlobalCodeword(mesh, local_shard.to(mesh.device))


def global_to_host_local(mesh: GlobalCodewordMesh, arr: GlobalCodeword
                         ) -> np.ndarray:
    """Inverse of host_local_to_global: this rank's chunk as numpy."""
    if arr.mesh is not mesh:
        raise ValueError("global_to_host_local: the codeword lives on "
                         "another mesh")
    return arr.local.cpu().numpy()


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's bytes, in rank order."""
    dev = _comm_device()
    size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    sizes = torch.empty((process_count(),), dtype=torch.int64, device=dev)
    _all_gather_flat(sizes, size)
    sizes = [int(v) for v in sizes.cpu()]
    buf = torch.zeros((max(sizes),), dtype=torch.uint8)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                          dtype=torch.uint8)
    gathered = torch.empty((len(sizes) * buf.numel(),), dtype=torch.uint8,
                           device=dev)
    _all_gather_flat(gathered, buf.to(dev))
    rows = gathered.cpu().numpy().reshape(len(sizes), -1)
    return [rows[i, :n].tobytes() for i, n in enumerate(sizes)]


def allgather_host_bytes(local_blocks: list) -> list:
    """Gather per-process lists of host bytes objects so every process ends
    with the full, identically ordered list (process order): Merkle leaf
    blocks or query responses before transcript assembly."""
    if process_count() == 1:
        return list(local_blocks)
    payload = b"".join(len(b).to_bytes(4, "little") + b for b in local_blocks)
    out = []
    for data in _allgather_bytes(payload):
        off = 0
        while off < len(data):
            n = int.from_bytes(data[off:off + 4], "little")
            off += 4
            out.append(data[off:off + n])
            off += n
    return out


def assert_same_on_all_processes(digest: bytes) -> None:
    """Bit-identity gate across processes: every process must have produced
    the same transcript digest."""
    if process_count() == 1:
        return
    if len(set(_allgather_bytes(digest))) != 1:
        raise AssertionError("multi-process transcript divergence")
