"""Sharded execution of the kernels over a device mesh (counterpart of
``isocon_tpu/parallel/sharding.py``).

The pair axis is block-sharded over the mesh: a batch of B pairs is padded
to n blocks of ceil(B/n) pairs (the padding repeats the last pair), each
block runs the kernel's wrapper on its device against that device's
replica of the pool, every block is launched before any is fetched, and
the host concatenates the results in block order and cuts the padding.
The pool is replicated (one copy a distinct device, kept for the pool's
life: only the rows it appends are copied, and the whole again when it
moves into larger storage); only the int32 index vectors and the per-pair
scores are split.  Under the multi-process seam (``distributed``) a
process runs the blocks of its own devices and the blocks are
all-gathered on the host, so every process reads the full result.

Every pair's result is its kernel's on that pair alone, so the results
equal the unsharded wrapper's whatever n, block size or kernel form a
block's launch size selects.

This module knows no kernel: ``Sharder.launch`` takes the kernel's wrapper
(``ops.myers.myers_ed_pool``, ``ops.affine_cuda.sg_align_pool``, ...) from
its caller, and nothing here imports ``ops``.  So the JAX ``Sharder``'s
per-kernel methods and its ``nn_round_sharded`` functions have no
counterpart; neither have its non-pooled methods (``banded_ed``,
``banded_sg_align``, ``sg_align_with_ops``), which serve the JAX engine's
non-Pallas route, where pairs travel as [B, L] code planes (every pair of
the port's engine goes through a pool).
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import distributed


def _pad_rows(x: np.ndarray, total: int) -> np.ndarray:
    """``x`` [B, ...] extended to ``total`` rows by repeating its last."""
    if x.shape[0] == total:
        return x
    return np.concatenate([x, np.repeat(x[-1:], total - x.shape[0], axis=0)])


def _pad_width(x: np.ndarray, width: int) -> np.ndarray:
    """A [B, w] block widened to ``width`` columns of zeros (past the end
    of the aligned rows, which ``fetch`` trims to each block's longest)."""
    if x.ndim < 2 or x.shape[1] == width:
        return x
    out = np.zeros((x.shape[0], width) + x.shape[2:], dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device`` without waiting for the stream: on a card it
    is copied into pinned host memory and sent with ``non_blocking``.
    ``arr`` may be rewritten at once; PyTorch's pinned-memory cache keeps
    the staging block until the copy has run.  On the CPU it is
    ``torch.from_numpy(arr)``."""
    if device.type != "cuda":
        return torch.from_numpy(arr).to(device)
    return torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)


class _Batch:
    """A sharded batch in flight: its size, each owned block's device
    outputs, and the function that reads one block's outputs to host
    arrays."""

    __slots__ = ("B", "blocks", "to_host")

    def __init__(self, B: int, blocks: list, to_host: Callable):
        self.B, self.blocks, self.to_host = B, blocks, to_host


def _host_arrays(res) -> Tuple[np.ndarray, ...]:
    """A wrapper's device output(s) as a tuple of host arrays."""
    if isinstance(res, torch.Tensor):
        res = (res,)
    return tuple(x.cpu().numpy() for x in res)


def _indexed(d) -> torch.device:
    """``d`` with its card's index, as a tensor's device always has it
    (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _storage_of(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose leading rows ``t`` is (a pool's ``tensors()`` are
    views of its preallocated storage), else ``t`` itself."""
    b = t._base
    if (b is not None and b.data_ptr() == t.data_ptr()
            and b.shape[1:] == t.shape[1:] and b.is_contiguous()):
        return b
    return t


class Sharder:
    """Runs pooled kernel batches over a mesh of devices, whatever the
    kernel: ``launch`` takes the kernel's wrapper as an argument.

    ``devices``: an ordered list of ``torch.device`` (``mesh.make_mesh``;
    entries may repeat, each is one shard) or a
    ``distributed.GlobalMesh``.  ``self.device`` is the first device this
    process owns: the engine keeps its pools there.  A Sharder of one
    device is the engine's unsharded path: one block, no padding, the
    pool used in place.

    ``launch`` starts a batch on every owned block and returns at once:
    its index and score vectors go up from pinned host memory without
    waiting for the stream; ``collect`` reads it to the host.  The engine
    launches all of a round's batches before it collects any, and
    collects them in launch order.
    """

    def __init__(self, devices: Sequence):
        ranks = getattr(devices, "ranks", None)
        self.devices = [_indexed(d) for d in devices]
        self.n = len(self.devices)
        if not self.n:
            raise ValueError("a Sharder needs at least one device")
        rank = distributed.process_index()
        self.ranks = list(ranks) if ranks is not None else [rank] * self.n
        self.multiprocess = len(set(self.ranks)) > 1
        # the blocks this process launches (the wrappers pick the card)
        self.local = [k for k in range(self.n) if self.ranks[k] == rank]
        if not self.local:
            raise ValueError("process %d owns no device of the mesh" % rank)
        self.device = self.devices[self.local[0]]
        # (device, id of a pool tensor's storage) -> (weak reference to
        # that storage, its copy on the device, rows copied)
        self._replicas: dict = {}

    def _replica(self, tensors: Tuple[torch.Tensor, ...],
                 dev: torch.device) -> Tuple[torch.Tensor, ...]:
        """The pool tensors on ``dev``: the tensors themselves on their own
        device, else each one's copy there."""
        if tensors[0].device == dev:
            return tensors
        return tuple(self._copy_on(t, dev) for t in tensors)

    def _copy_on(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t`` on ``dev`` from a copy of its storage kept while the storage
        lives.  A pool only appends rows (``ops.engine._SeqPool``), so only
        the rows added since the last call are copied; when the pool grows
        into new storage the old one dies, its copy is dropped, and the new
        one is copied whole.  The storage is held only weakly."""
        base = _storage_of(t)
        key = (dev, id(base))
        hit = self._replicas.get(key)
        if hit is None or hit[0]() is not base:
            hit = (weakref.ref(base, lambda _ref, key=key:
                               self._replicas.pop(key, None)),
                   torch.empty_like(base, device=dev), 0)
        ref, copy, done = hit
        rows = t.shape[0]
        if rows > done:
            copy[done:rows] = t[done:rows].to(dev)
            done = rows
        self._replicas[key] = (ref, copy, done)
        return copy[:rows]

    def launch(self, fn: Callable, tensors, vectors: Sequence[np.ndarray],
               to_host: Callable = _host_arrays, **kw) -> _Batch:
        """``fn(*pool tensors, *block vectors, **kw)`` on each owned block
        of the host vectors (padded with their last entry to n blocks of
        ceil(B/n)), against that device's copy of the pool; nothing is
        fetched.  ``to_host`` reads one block's outputs to host arrays."""
        B = len(vectors[0])
        blk = -(-B // self.n)
        padded = [_pad_rows(np.ascontiguousarray(v), blk * self.n)
                  for v in vectors]
        blocks = []
        for k in self.local:
            dev = self.devices[k]
            sl = slice(k * blk, (k + 1) * blk)
            blocks.append(fn(*self._replica(tensors, dev), *[
                upload(v[sl], dev) for v in padded], **kw))
        return _Batch(B, blocks, to_host)

    def collect(self, batch: _Batch) -> Tuple[np.ndarray, ...]:
        """A launched batch's outputs as host arrays of its B rows, in pair
        order: the blocks read, all-gathered under several processes,
        joined in block order and cut of their padding."""
        blocks = [batch.to_host(res) for res in batch.blocks]
        if self.multiprocess:
            blocks = self._gather(blocks)
        if len(blocks) == 1:
            return tuple(x[:batch.B] for x in blocks[0])
        out = []
        for i in range(len(blocks[0])):
            parts = [b[i] for b in blocks]
            width = max(p.shape[1] if p.ndim > 1 else 0 for p in parts)
            out.append(np.concatenate(
                [_pad_width(p, width) for p in parts])[:batch.B])
        return tuple(out)

    def _gather(self, own: List[Tuple[np.ndarray, ...]]
                ) -> List[Tuple[np.ndarray, ...]]:
        """Every block of the mesh, in mesh order, from each process's own
        blocks: one host all-gather an output, of equal-sized blocks."""
        nout = len(own[0])
        width = np.array([max(b[i].shape[1] if b[i].ndim > 1 else 0
                              for b in own) for i in range(nout)], np.int64)
        width = np.max(distributed.all_gather(width), axis=0)
        kmax = max(self.ranks.count(r) for r in set(self.ranks))
        where = {}                     # rank -> its mesh positions
        for k, r in enumerate(self.ranks):
            where.setdefault(r, []).append(k)
        blocks: List[list] = [[None] * nout for _ in range(self.n)]
        for i in range(nout):
            stack = [_pad_width(b[i], int(width[i])) for b in own]
            stack += [np.zeros_like(stack[0])] * (kmax - len(stack))
            for r, got in enumerate(distributed.all_gather(np.stack(stack))):
                for j, k in enumerate(where.get(r, [])):
                    blocks[k][i] = got[j]
        return [tuple(b) for b in blocks]
