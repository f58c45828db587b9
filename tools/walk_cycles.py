#!/usr/bin/env python3
"""Where K4's time goes, per warp: the walk's steps against its tile copies,
and its epilogue, the aligned rows.

Builds a copy of ``isocon_tpu_torch/csrc/affine_sg.cu`` with ``clock64()``
counters around each tile copy and around each pair's walk (a few lines
edited in at fixed places of the walk kernel; the copy is built in a
temporary directory, the tree's kernel stays as it is), and runs it on K3's
direction bytes at ``tools/kernel_time.py``'s shapes (``K3_SHAPES``), with
the pairs' sequences for the rows.  For each shape it prints the
instrumented launch's ms (CUDA events), the steps and tiles a pair, the
cycles a step outside the tile copies, the cycles a tile copy and the
copies' share of the walk's cycles, and the epilogue's cycles a pair and
its share of a pair's cycles, summed over warps.
The counters add a few instructions a step and a tile, so the ms is not
the kernel's: ``kernel_time.py --kernel k4`` times that.  Needs nvcc and
a card.

    python tools/walk_cycles.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (text of the walk kernel, the same with a counter) in the order they occur
EDITS = (
    ("constexpr int kRing = 128;\n",
     "constexpr int kRing = 128;\n"
     "__device__ unsigned long long g_clocks[5];\n"),
    ("    int top = -1, ulo = 0;\n    int k = 0;\n",
     "    int top = -1, ulo = 0;\n    int k = 0;\n"
     "    long long t_pair = clock64(), t_copy = 0, copies = 0;\n"),
    ("        top = dd;\n",
     "        const long long t0 = clock64();\n        ++copies;\n"
     "        top = dd;\n"),
    ("        asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "        __syncwarp();\n",
     "        asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "        __syncwarp();\n        t_copy += clock64() - t0;\n"),
    ("    // the rows need the whole opcode row",
     "    const long long t_rows = clock64();\n"
     "    // the rows need the whole opcode row"),
    ("    if (lane == 0) {\n      fi_out[b] = i;",
     "    if (lane == 0) {\n"
     "      atomicAdd(&g_clocks[0], (unsigned long long)(t_rows - t_pair));\n"
     "      atomicAdd(&g_clocks[4],\n"
     "                (unsigned long long)(clock64() - t_rows));\n"
     "      atomicAdd(&g_clocks[1], (unsigned long long)t_copy);\n"
     "      atomicAdd(&g_clocks[2], (unsigned long long)copies);\n"
     "      atomicAdd(&g_clocks[3], (unsigned long long)k);\n"
     "      fi_out[b] = i;"),
)

READ_ENTRY = """
ISOCON_API int isocon_walk_clocks(void* out, int reset) {
  if (reset) {
    const unsigned long long z[5] = {0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_clocks, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_clocks, 5 * sizeof(unsigned long long)));
}
"""


def build(_build, tmp):
    """The instrumented library, built from this tree's source."""
    with open(os.path.join(_build.CSRC, "affine_sg.cu")) as fh:
        src = fh.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            sys.exit("walk_cycles: the walk kernel changed; update EDITS")
        src = src.replace(old, new)
    path = os.path.join(tmp, "affine_sg_clocks.cu")
    with open(path, "w") as fh:
        fh.write(src + READ_ENTRY)
    lib = os.path.join(tmp, "libaffine_sg_clocks.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit("walk_cycles: nvcc failed:\n" + proc.stdout + proc.stderr)
    so = ctypes.CDLL(lib)
    so.isocon_affine_walk.argtypes = _build._SIGNATURES["isocon_affine_walk"]
    so.isocon_affine_walk.restype = ctypes.c_int
    so.isocon_walk_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    so.isocon_walk_clocks.restype = ctypes.c_int
    return so


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from kernel_time import K3_SHAPES

    if not torch.cuda.is_available():
        sys.exit("walk_cycles: no CUDA device")
    from isocon_tpu_torch.ops import _build
    from isocon_tpu_torch.ops import affine_cuda as acu

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit,clocks.max.sm"))
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        so = build(_build, tmp)
        chunk = cs.k5_chunk(torch, np, dev)
        for B, Wp, long_copies in K3_SHAPES:
            batch = cs.k3_batch(torch, np, dev, B,
                                chunk if long_copies else None)
            _ms, (_best, ei, ej, dirs), _nb, _ops, shape = cs.time_k3(
                torch, acu, batch, Wp)
            nops = int((batch[3] + batch[4]).max()) + 1
            _, S, _ = dirs.shape
            ops = torch.zeros((B, nops), dtype=torch.uint8, device=dev)
            fi, fj, ov, counter, alen, nmat, nmis = (
                torch.empty(B, dtype=torch.int32, device=dev)
                for _ in range(7))
            a1, a2 = (torch.empty((B, nops - 1), dtype=torch.uint8,
                                  device=dev) for _ in range(2))
            pool = batch[0]
            seqs = [x.to(torch.int32).contiguous() for x in batch[1:5]]
            args = [dirs, ei, ej, ops, fi, fj, ov, counter, pool, *seqs, a1,
                    a2, alen, nmat, nmis]
            stream = torch.cuda.current_stream(dev).cuda_stream

            def walk():
                _build.check(so.isocon_affine_walk(
                    *[P(a.data_ptr()) for a in args], I(B), I(S), I(Wp),
                    I(nops), I(acu.WALK_TILE_ROWS), I(pool.shape[1]),
                    P(stream)), "walk")

            walk()                                  # warm-up
            torch.cuda.synchronize()
            _build.check(so.isocon_walk_clocks(None, 1), "reset")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            walk()
            end.record()
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 5)()
            _build.check(so.isocon_walk_clocks(ctypes.cast(out, P), 0),
                         "read")
            pair, copy, tiles, steps, rows = out
            print("%s: %.4f ms instrumented; %.0f steps and %.1f tiles a "
                  "pair; %.1f cycles a step outside the copies, %.0f a "
                  "tile copy; copies %.3f of the walk's cycles; the rows "
                  "%.0f cycles a pair, %.3f of a pair's"
                  % (shape, start.elapsed_time(end), steps / B, tiles / B,
                     (pair - copy) / steps, copy / max(tiles, 1),
                     copy / pair, rows / B, rows / (pair + rows)),
                  flush=True)
            del dirs, ops, a1, a2
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
