"""Device meshes of the port (counterpart of ``isocon_tpu/parallel/mesh.py``).

The parallelism is data-parallel over the pair axis: a batch's pairs are
split into contiguous blocks, one per entry of the mesh, and each block
runs the same kernel on its device (``sharding.Sharder``).  A mesh is an
ordered list of ``torch.device``s; an entry may repeat, and each entry is
one shard.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """The first ``n_devices`` devices of ``device``'s type, in order.

    CUDA: the first n visible cards (fewer when fewer are visible, as
    ``jax.devices()[:n]`` gives; ``None`` or -1: all of them).  Raises
    when no card is visible: a CUDA mesh never becomes a CPU run.
    CPU, which torch shows as one device: n logical shards of ``cpu``
    (``None`` or -1: one)."""
    kind = torch.device(device).type
    if n_devices is not None and n_devices != -1 and n_devices < 1:
        raise ValueError("a mesh needs n_devices >= 1 or -1, got %d"
                         % n_devices)
    every = n_devices is None or n_devices == -1
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass device="
                               "'cpu' (--device cpu) for a CPU mesh")
        devs = [torch.device("cuda", i) for i in range(count)]
        return devs if every else devs[:n_devices]
    if kind == "cpu":
        return [torch.device("cpu")] * (1 if every else n_devices)
    raise ValueError("no mesh for device type %r" % kind)
