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

The JAX ``Sharder``'s non-pooled methods (``banded_ed``,
``banded_sg_align``, ``sg_align_with_ops``) serve the JAX engine's
non-Pallas route, where pairs travel as [B, L] code planes; the port's
engine has no such route (every pair goes through a pool), so they have
no counterpart here.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.affine_cuda import fetch, sg_align_pool
from ..ops.myers import WIN, myers_ed_pool, myers_hw_pool
from ..ops.wavefront import banded_ed_pool
from . import distributed

UNREACHED = 2 ** 30   # the NN rounds' minimum where no pair is in band


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
    """Runs the engine's pooled kernel batches over a mesh of devices.

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

    # ------------------------------------------------------------------
    # the engine's four pooled routes, launched and collected at once;
    # index vectors and scores are host arrays, the outputs host numpy
    # arrays
    # ------------------------------------------------------------------
    def myers_ed_pool(self, pool, plen, peq, ia, ib, *, L: int,
                      win: Optional[int] = WIN) -> np.ndarray:
        """K1 (``ops.myers.myers_ed_pool``): ed int32 [B]."""
        return self.collect(self.launch(myers_ed_pool, (pool, plen, peq),
                                        (ia, ib), L=L, win=win))[0]

    def myers_hw_pool(self, pool, plen, peq, ia, ib, *, L: int,
                      win: Optional[int] = WIN
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """K2 (``ops.myers.myers_hw_pool``): (ed, ej) int32 [B]."""
        return self.collect(self.launch(myers_hw_pool, (pool, plen, peq),
                                        (ia, ib), L=L, win=win))

    def banded_ed_pool(self, pool, plen, ia, ib, *, Wp: int,
                       hw_mode: bool = False, small: Optional[bool] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """K5 (``ops.wavefront.banded_ed_pool``): (ed, end_j) int32 [B]."""
        return self.collect(self.launch(banded_ed_pool, (pool, plen),
                                        (ia, ib), Wp=Wp, hw_mode=hw_mode,
                                        small=small))

    def sg_align_pool(self, pool, plen, ia, ib, match, mismatch, gopen,
                      gext, *, Wp: int) -> Tuple[np.ndarray, ...]:
        """K3 + K4 (``ops.affine_cuda.sg_align_pool``): the eleven host
        outputs of ``fetch``, the aligned rows trimmed to the longest."""
        return self.collect(self.launch(
            sg_align_pool, (pool, plen),
            (ia, ib, match, mismatch, gopen, gext), to_host=fetch, Wp=Wp))


def _code_pool(codes: np.ndarray, lens: np.ndarray, dev: torch.device):
    return (torch.from_numpy(np.ascontiguousarray(codes).view(np.uint8)
                             .copy()).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32).copy()).to(dev))


def nn_round_sharded(mesh, q, t, qlen, tlen, query_ids, n_queries: int, *,
                     Wp: int, L: int) -> np.ndarray:
    """One sharded NN-search round: the banded EDs (K5, ``small=False`` at
    any Wp, as the JAX function's ``banded_ed``) of pairs (q[b], t[b]),
    pair axis split over ``mesh`` (a device list), then
    each query's minimum over its pairs, merged on the host as ``pmin``
    merges the shards' minima.  q, t: int8 [B, L] codes; returns int32
    [n_queries] (2^30 for a query with no pair)."""
    if q.shape[1] != L or t.shape[1] != L:
        raise ValueError("q and t must be [B, L] with L = %d" % L)
    sharder = Sharder(mesh)
    B = q.shape[0]
    pool, plen = _code_pool(np.concatenate([q, t]),
                            np.concatenate([qlen, tlen]), sharder.device)
    ia = np.arange(B, dtype=np.int32)
    ed, _ = sharder.banded_ed_pool(pool, plen, ia, ia + B, Wp=Wp,
                                   small=False)
    out = np.full(n_queries, UNREACHED, dtype=np.int32)
    np.minimum.at(out, np.asarray(query_ids, np.int64), ed)
    return out


def nn_round_sharded_2d(devices_2d, seqs, lens, *, Wp: int,
                        L: int) -> np.ndarray:
    """2-D blocked all-pairs distance minima: a grid of R x C devices
    (nested lists) tiles the pairwise matrix; device (i, j) runs the banded
    EDs (K5, ``small=False``) of row block i against column block j, the
    self-pairs and every ed <= 0 count as 2^30, and each row's minimum
    merges over its C tiles on the host.  seqs: int8 [N, L] codes, N a
    multiple of R x C; returns int32 [N], each sequence's least ED to
    another (2^30 where none is in band)."""
    grid = [list(row) for row in devices_2d]
    R, C = len(grid), len(grid[0])
    N = seqs.shape[0]
    if N % (R * C) or seqs.shape[1] != L:
        raise ValueError("seqs must be [N, %d] with N a multiple of %d"
                         % (L, R * C))
    nr, nc = N // R, N // C
    sharder = Sharder([d for row in grid for d in row])
    pool, plen = _code_pool(seqs, lens, sharder.device)
    # tile (i, j) is block i * C + j of the flattened grid: nr * nc pairs
    ti, tj = np.divmod(np.arange(R * C), C)
    ia = (ti[:, None] * nr + np.repeat(np.arange(nr), nc)[None]).ravel()
    ib = (tj[:, None] * nc + np.tile(np.arange(nc), nr)[None]).ravel()
    ed, _ = sharder.banded_ed_pool(pool, plen, ia.astype(np.int32),
                                   ib.astype(np.int32), Wp=Wp, small=False)
    ed = np.where(ed <= 0, UNREACHED, ed).reshape(R, C, nr, nc)
    return ed.min(axis=3).min(axis=1).reshape(N).astype(np.int32)
