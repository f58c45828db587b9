"""Pool-gather wrapper of the affine kernels K3 (forward) and K4 (walk).

Counterpart of ``isocon_tpu/ops/affine_pallas_c.py``
(``sg_align_pool_pallas_c``): the pairs' sequences are read from the
device-resident pool by row index, the per-pair scores go in as int32
vectors, and the kernels return (best, ei, ej, ops, fi, fj, overflow)
and the aligned rows.
For CUDA tensors ``affine_fwd`` / ``affine_walk`` launch
``csrc/affine_sg.cu``; for CPU tensors they run the plain versions in
``affine.py``.

Wire format: ``ops`` is uint8 [B, nops] with nops = max(n + m) + 1, one
opcode per walk step, backward and contiguous, OP_NONE after the walk
ends.  K4 also turns each walk into the pair's two aligned rows, ``a1``
and ``a2`` uint8 [B, nops - 1] (the ASCII strings the JAX package's
``ops_to_alignment_counts`` builds from the opcodes), with their length
and the walk's matches and mismatches.  ``fetch`` copies the
outputs but the opcodes to the host, the rows trimmed to the longest
aligned length.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .affine import sg_forward_plain, sg_rows_plain, sg_walk_plain

KERNEL_WPS = (256, 512, 1024, 2048, 4096, 8192)
# K4 stages the direction bytes in tiles of this many diagonals (rows of
# dirs) by WALK_TILE_ROWS + 16 lanes; the C entry takes only the sizes it
# was compiled for (64), and tests/test_torch_walk_tiles.py emulates the
# kernel's addressing with this constant.
WALK_TILE_ROWS = 64


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def affine_fwd(pool: torch.Tensor, qrow: torch.Tensor, trow: torch.Tensor,
               n: torch.Tensor, m: torch.Tensor, match: torch.Tensor,
               mismatch: torch.Tensor, gopen: torch.Tensor,
               gext: torch.Tensor, *, Wp: int, nm_max: Optional[int] = None):
    """K3 over pool rows: -> (best, ei, ej) int32 [B], dirs uint8 [B, S, W].
    ``nm_max``: the longest n + m, if the caller knows it (see
    ``affine_fwd_cuda``)."""
    if pool.device.type == "cpu":
        return sg_forward_plain(pool[qrow.long()], pool[trow.long()], n, m,
                                match, mismatch, gopen, gext, Wp)
    return affine_fwd_cuda(pool, qrow, trow, n, m, match, mismatch, gopen,
                           gext, Wp=Wp, warps=0, nm_max=nm_max)


def affine_fwd_cuda(pool: torch.Tensor, qrow: torch.Tensor,
                    trow: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                    match: torch.Tensor, mismatch: torch.Tensor,
                    gopen: torch.Tensor, gext: torch.Tensor, *, Wp: int,
                    warps: int, nm_max: Optional[int] = None):
    """K3's launch on CUDA tensors.  ``warps``: the register kernel's warps
    a pair (1, 2 or 4; 0 lets the launch size choose, as ``affine_fwd``
    does), so that its forms can be timed at one batch size.  ``nm_max``:
    the longest n + m of the batch (at least its true value), which sizes
    the direction scratch; without it the launch reads it from ``n`` and
    ``m``, which waits for the stream."""
    if Wp not in KERNEL_WPS:
        raise ValueError("no affine kernel for band width %d" % Wp)
    if pool.dtype != torch.uint8 or pool.shape[1] % 8:
        raise ValueError("pool must be uint8 with width % 8 == 0")
    lib = _build.load("affine_sg")
    dev = pool.device
    B = qrow.shape[0]
    W = Wp // 2
    if nm_max is None:
        nm_max = int((n + m).max()) if B else 0
    S = max(int(nm_max) - 1, 1)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    ei = torch.empty_like(best)
    ej = torch.empty_like(best)
    dirs = torch.empty((B, S, W), dtype=torch.uint8, device=dev)
    if B == 0:
        return best, ei, ej, dirs
    # the register kernel's pair counter; the C entry zeroes it
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = [pool.contiguous(), _i32(qrow), _i32(trow), _i32(n), _i32(m),
            _i32(match), _i32(mismatch), _i32(gopen), _i32(gext),
            best, ei, ej, dirs, counter]
    for a in args:
        if a.device != dev:
            raise ValueError("affine inputs on mixed devices")
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch(dev, "affine_fwd", lib.isocon_affine_fwd,
                  *[P(a.data_ptr()) for a in args], ctypes.c_int(B),
                  ctypes.c_int(pool.shape[1]), ctypes.c_int(Wp),
                  ctypes.c_int(S), ctypes.c_int(warps), P(stream))
    return best, ei, ej, dirs


def affine_walk(dirs: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, *,
                Wp: int, nops: int, seqs):
    """K4 and its epilogue: -> (ops uint8 [B, nops], fi, fj int32 [B],
    overflow bool [B], a1, a2 uint8 [B, nops - 1], alen, nmat, nmis int32
    [B]).  ``seqs`` = (pool, qrow, trow, n, m): each pair's query and
    target as pool rows and lengths, of which the epilogue writes each
    walk's aligned rows, their length and the walk's matches and
    mismatches, as ``affine.sg_rows_plain``; ``nops`` must exceed
    max(n + m).  On the card the bytes of a row past its length are left
    unwritten."""
    pool, qrow, trow, n, m = seqs
    if dirs.device.type == "cpu":
        ops, fi, fj, ov = sg_walk_plain(dirs, ei, ej, Wp, nops)
        return (ops, fi, fj, ov) + sg_rows_plain(
            ops, ei, ej, fi, fj, ov, pool[qrow.long()], pool[trow.long()],
            n, m, nops - 1)
    if Wp not in KERNEL_WPS:
        raise ValueError("no affine kernel for band width %d" % Wp)
    if pool.dtype != torch.uint8:
        raise ValueError("pool must be uint8")
    lib = _build.load("affine_sg")
    dev = dirs.device
    B, S, W = dirs.shape
    if W != Wp // 2:
        raise ValueError("dirs width %d does not match band %d" % (W, Wp))
    ops = torch.zeros((B, nops), dtype=torch.uint8, device=dev)
    fi = torch.empty(B, dtype=torch.int32, device=dev)
    fj, ov, alen, nmat, nmis = (torch.empty_like(fi) for _ in range(5))
    a1 = torch.empty((B, nops - 1), dtype=torch.uint8, device=dev)
    a2 = torch.empty_like(a1)
    if B == 0:
        return ops, fi, fj, ov != 0, a1, a2, alen, nmat, nmis
    # the persistent grid's pair counter; the C entry zeroes it
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = [dirs.contiguous(), _i32(ei), _i32(ej), ops, fi, fj, ov, counter,
            pool.contiguous(), _i32(qrow), _i32(trow), _i32(n), _i32(m), a1,
            a2, alen, nmat, nmis]
    if any(a.device != dev for a in args):
        raise ValueError("affine inputs on mixed devices")
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch(dev, "affine_walk", lib.isocon_affine_walk,
                  *[P(a.data_ptr()) for a in args], ctypes.c_int(B),
                  ctypes.c_int(S), ctypes.c_int(Wp), ctypes.c_int(nops),
                  ctypes.c_int(WALK_TILE_ROWS), ctypes.c_int(pool.shape[1]),
                  P(stream))
    return ops, fi, fj, ov != 0, a1, a2, alen, nmat, nmis


def sg_align_pool(pool: torch.Tensor, plen: torch.Tensor, ia: torch.Tensor,
                  ib: torch.Tensor, match: torch.Tensor,
                  mismatch: torch.Tensor, gopen: torch.Tensor,
                  gext: torch.Tensor, *, Wp: int,
                  nm_max: Optional[int] = None):
    """Semi-global alignment of pool rows ia[b] (query) vs ib[b] (target)
    in a band of width Wp.  Scores are per pair (mismatch < 0; open/ext
    as positive penalties).  ``nm_max``: the longest n + m of the pairs
    (at least its true value), from the caller, so that the launches do
    not wait for the stream; None reads it from the pool's lengths.
    Returns (best, ei, ej, ops, fi, fj, overflow, a1, a2, alen, nmat, nmis)
    on the pool's device (``affine_walk``'s outputs after K3's).  K3's
    direction scratch is dropped once K4 is queued, so the caching
    allocator reuses it in stream order."""
    ia = ia.long()
    ib = ib.long()
    n = plen[ia]
    m = plen[ib]
    if nm_max is None:
        nm_max = int((n + m).max()) if ia.numel() else 0
    best, ei, ej, dirs = affine_fwd(pool, ia, ib, n, m, match, mismatch,
                                    gopen, gext, Wp=Wp, nm_max=nm_max)
    walk = affine_walk(dirs, ei, ej, Wp=Wp, nops=int(nm_max) + 1,
                       seqs=(pool, ia, ib, n, m))
    return (best, ei, ej) + walk


def fetch(outs) -> Tuple[np.ndarray, ...]:
    """Host copies of ``sg_align_pool``'s outputs: (best, ei, ej, fi, fj,
    overflow, alen, nmat, nmis, a1, a2), the rows trimmed to the longest
    aligned length (a row's bytes past its own length are not its own).
    The opcodes stay on the device.  Two copies: the vectors, both rows."""
    best, ei, ej, _ops, fi, fj, ov, a1, a2, alen, nmat, nmis = outs
    vec = torch.stack([best, ei, ej, fi, fj, ov.to(torch.int32), alen, nmat,
                       nmis]).cpu().numpy()
    A = max(int(vec[6].max()), 1) if vec.shape[1] else 1
    # one copy of both, each row array contiguous on the host
    rows = torch.stack([a1[:, :A], a2[:, :A]]).cpu().numpy()
    return (vec[0], vec[1], vec[2], vec[3], vec[4], vec[5] != 0, vec[6],
            vec[7], vec[8], rows[0], rows[1])
