"""Multi-process execution seam (counterpart of
``isocon_tpu/parallel/distributed.py``), on ``torch.distributed`` with the
gloo backend.

As in the JAX package, every process runs the whole host program on the
whole input, and only the engine's pair axis is split: over the global
mesh, every process's local devices in rank order.  A process launches
the blocks of its own devices; the blocks, padded to one size, are
all-gathered on the host (CPU tensors over gloo), so every process reads
the full result and the engine's host loops stay unchanged.  Pools are
not sent: every process interns the same sequences itself.

Launch (one command per process, the same everywhere but the id):

    ISOCON_COORDINATOR=host0:8476 ISOCON_NUM_PROCESSES=2 \\
    ISOCON_PROCESS_ID=<i> python -m isocon_tpu_torch.cli pipeline \\
        -fl_reads reads.fa -outfolder out_<i>/ --devices -1

``python -m isocon_tpu_torch.parallel.dryrun`` runs the seam with N
processes on localhost.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist


class GlobalMesh(list):
    """A mesh over the devices of every process: the devices in block
    order, and ``ranks[k]``, the process that owns entry k."""

    def __init__(self, devices: Sequence[torch.device],
                 ranks: Sequence[int]):
        super().__init__(torch.device(d) for d in devices)
        self.ranks = [int(r) for r in ranks]
        if len(self.ranks) != len(self):
            raise ValueError("one rank per device")


def initialize_from_env() -> bool:
    """Join a multi-process group when ``ISOCON_COORDINATOR`` (host:port),
    ``ISOCON_NUM_PROCESSES`` and ``ISOCON_PROCESS_ID`` are set (no-op
    otherwise).  Returns True when running multi-process."""
    coord = os.environ.get("ISOCON_COORDINATOR")
    if not coord:
        return False
    initialize(coord, int(os.environ["ISOCON_NUM_PROCESSES"]),
               int(os.environ["ISOCON_PROCESS_ID"]))
    return True


def initialize(coordinator: str, num_processes: int, process_id: int,
               timeout_s: float = 600.0) -> None:
    """``init_process_group("gloo")`` at ``tcp://coordinator``; raises when
    it fails or times out.  A second call with the same group is a no-op."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError("already in a process group of %d as rank %d"
                               % (dist.get_world_size(), dist.get_rank()))
        return
    dist.init_process_group(
        "gloo", init_method="tcp://" + coordinator,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(local_devices: Sequence) -> GlobalMesh:
    """Every process's ``local_devices`` in rank order, each entry with its
    owner's rank."""
    local = [torch.device(d) for d in local_devices]
    if not local:
        raise ValueError("a process needs at least one local device")
    if process_count() == 1:
        return GlobalMesh(local, [0] * len(local))
    names: List = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in local])
    devices, ranks = [], []
    for rank, theirs in enumerate(names):
        devices += theirs
        ranks += [rank] * len(theirs)
    return GlobalMesh(devices, ranks)


def all_gather(x: np.ndarray) -> List[np.ndarray]:
    """Every process's ``x`` in rank order, sent as bytes over gloo; every
    process passes an array of the same shape and dtype."""
    x = np.ascontiguousarray(x)
    t = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return [p.numpy().view(x.dtype).reshape(x.shape) for p in parts]
