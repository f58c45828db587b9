"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes``; pointers and the stream go in as ``c_void_p``.  Libraries are
named by a hash of their sources and flags and built at first use into
``isocon_tpu_torch/_build/`` (listed in ``.gitignore``); ``build_all``
starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches per kernel: ``launch``, through which
every wrapper calls its C entry, adds one there and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SOURCES = ("myers_ed", "affine_sg", "wavefront_ed", "sketch", "consensus")

LAUNCHES: Dict[str, int] = {"myers_ed": 0, "myers_hw": 0, "affine_fwd": 0,
                            "affine_walk": 0, "wavefront_ed": 0,
                            "sketch_scores": 0, "sketch_topn": 0,
                            "sketch_merge": 0, "kmer_profile": 0,
                            "consensus_vote": 0, "consensus_correct": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "isocon_myers_ed": [_P] * 7 + [_I] * 4 + [_P],
    "isocon_myers_hw": [_P] * 8 + [_I] * 4 + [_P],
    "isocon_affine_fwd": [_P] * 14 + [_I] * 5 + [_P],
    "isocon_affine_walk": [_P] * 18 + [_I] * 6 + [_P],
    "isocon_wavefront_ed": [_P] * 9 + [_I] * 7 + [_P],
    "isocon_sketch_scores": [_P] * 4 + [_I] * 6 + [_P],
    "isocon_sketch_topn": [_P] * 4 + [_I] * 5 + [_P],
    "isocon_sketch_merge": [_P] * 4 + [_I] * 3 + [_P],
    "isocon_kmer_profile": [_P] * 3 + [_I] + [_P],
    "isocon_consensus_vote": [_P] * 7 + [_I] * 2 + [_P],
    "isocon_consensus_correct": [_P] * 10 + [_I] * 2 + [_P],
}

_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: List[str] = []     # nvcc's -Xptxas -v report of each build


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == name + ".cu" or fn.endswith(".h"):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build_all() -> float:
    """Compile every source that has no current library, one nvcc each,
    all started together.  Returns the wall seconds spent; raises with
    nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG.append("== %s ==\n%s" % (name, log))
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all()
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed: cudaError %d" % (what, rc))


def launch(dev, counter: str, entry, *args) -> None:
    """Call the C entry ``entry(*args)`` for the card ``dev``, raise on its
    error, and count one launch of ``counter``.  The entries launch on the
    host thread's current card (and read its SM count), while the stream
    they are given belongs to ``dev``: so the call runs with ``dev``
    current."""
    import torch

    with torch.cuda.device(dev):
        rc = entry(*args)
    check(rc, counter)
    LAUNCHES[counter] += 1
