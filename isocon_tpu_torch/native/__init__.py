"""Host (C++) libraries of the engine: the HW traceback of the
ends-ignored candidate graph and the CPU route's NW edit distances.

``hw_traceback.cc`` and ``myers_ed.cc`` are each built with ``g++ -O3
-shared -fPIC`` at first use into ``isocon_tpu_torch/_build/`` (named by a
hash of the source and the flags) and loaded with ``ctypes``.  A failed
build raises: there is no fallback to a per-pair Python loop, which would
take hours at the pair counts of a real run and hide the fault.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int64
# source name -> {C entry: (restype, argtypes)}
_ENTRIES = {
    "hw_traceback": {"hw_traceback_batch": (None, [_P, _P, _P, _P, _I, _I,
                                                   _P, _P, _I, _P, _I, _P])},
    "myers_ed": {"myers_ed": (_I, [_P, _I, _P, _I, _I]),
                 "myers_ed_batch_k": (None, [_P, _P, _P, _P, _I, _I, _P, _I,
                                             _P])},
}


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_HERE, name + ".cc"), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build(name: str = "hw_traceback") -> str:
    """Compile ``<name>.cc`` if it has no current build; returns its path.
    Raises with the compiler's output if the build fails."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.run(["g++", *_FLAGS, "-o", tmp,
                           os.path.join(_HERE, name + ".cc")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed for %s.cc:\n%s" % (name, proc.stdout))
    os.replace(tmp, out)
    return out


def get_lib(name: str = "hw_traceback") -> ctypes.CDLL:
    """The loaded library of ``<name>.cc`` (built on first use)."""
    with _LOCK:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for entry, (res, args) in _ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.restype = res
                fn.argtypes = args
            _libs[name] = lib
        return lib


def _nthreads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def hw_traceback_batch(pairs: Sequence[Tuple[str, str]], band: int = 128,
                       ed_hint=None, k_cap=None
                       ) -> List[Tuple[int, int, int, str]]:
    """Batched threaded HW (infix) tracebacks with internal band
    escalation.  ``pairs`` is a sequence of (q, t) strings; returns a list
    of (ed, start_j, end_j_incl, ops), ops over "=XDI" (D consumes t, I
    consumes q).

    ``ed_hint[i]`` (>= 0, typically the K2 prefilter's distance) starts
    pair i at band = max(16, 2*hint), which certifies immediately; a
    too-small hint merely escalates, never changes the result.

    ``k_cap[i]`` (>= 0) makes the result give up once ed > cap is proven:
    the entry becomes (-1, 0, 0, "") (edlib's ``k`` contract); -1 or no
    k_cap means no cutoff.  The C++ early give-up engages for cap > 0; a
    cap of 0 is honoured by the filter below."""
    B = len(pairs)
    if B == 0:
        return []
    lib = get_lib()
    bands = np.full(B, band, dtype=np.int64)
    if ed_hint is not None:
        h = np.asarray(ed_hint, dtype=np.int64)
        known = h >= 0
        bands[known] = np.maximum(16, 2 * h[known])
    caps = None if k_cap is None else np.ascontiguousarray(k_cap,
                                                           dtype=np.int64)
    L = max(1, max(max(len(q), len(t)) for q, t in pairs))
    # np.empty: the C++ side reads only each row's length prefix
    qs = np.empty((B, L), dtype=np.uint8)
    ts = np.empty((B, L), dtype=np.uint8)
    ql = np.zeros(B, dtype=np.int64)
    tl = np.zeros(B, dtype=np.int64)
    for i, (q, t) in enumerate(pairs):
        qb, tb = q.encode("latin1"), t.encode("latin1")
        qs[i, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
        ts[i, : len(tb)] = np.frombuffer(tb, dtype=np.uint8)
        ql[i], tl[i] = len(qb), len(tb)
    ops_stride = 2 * L + 16
    ops = np.zeros((B, ops_stride), dtype=np.uint8)
    meta = np.zeros((B, 3), dtype=np.int64)
    lib.hw_traceback_batch(
        qs.ctypes.data, ql.ctypes.data, ts.ctypes.data, tl.ctypes.data,
        L, B, bands.ctypes.data,
        caps.ctypes.data if caps is not None else None,
        _nthreads(), ops.ctypes.data, ops_stride, meta.ctypes.data)
    out = []
    for i in range(B):
        ed = int(meta[i, 0])
        if ed == -2:    # a walk is at most n + m ops: cannot happen
            raise RuntimeError("HW traceback overflowed its ops buffer")
        if ed == -1 or (caps is not None and 0 <= caps[i] < ed):
            out.append((-1, 0, 0, ""))
            continue
        row = ops[i]
        nul = int(np.argmin(row)) if row[-1] == 0 else ops_stride
        out.append((ed, int(meta[i, 1]), int(meta[i, 2]),
                    row[:nul].tobytes().decode("latin1")))
    return out


def _codes(x) -> np.ndarray:
    if isinstance(x, (bytes, bytearray)):
        return np.frombuffer(x, dtype=np.uint8)
    return np.ascontiguousarray(x, dtype=np.uint8)


def myers_ed(q, t, k: int = -1) -> int:
    """Unit-cost NW edit distance of byte codes ``q`` and ``t`` (bytes or
    uint8 arrays); -1 where it exceeds ``k`` (k < 0: no cutoff)."""
    qa, ta = _codes(q), _codes(t)
    return int(get_lib("myers_ed").myers_ed(qa.ctypes.data, len(qa),
                                             ta.ctypes.data, len(ta), int(k)))


def myers_ed_batch_k(qs: np.ndarray, qlens: np.ndarray, ts: np.ndarray,
                     tlens: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """NW edit distances of the rows of padded uint8 [B, L] code planes,
    pair i being qs[i, :qlens[i]] against ts[i, :tlens[i]], with a cutoff
    ks[i] each (k < 0: none), threaded over up to 16 host cores.  Returns
    int64 [B], -1 where the distance exceeds its cutoff."""
    qs = np.ascontiguousarray(qs, dtype=np.uint8)
    ts = np.ascontiguousarray(ts, dtype=np.uint8)
    if qs.ndim != 2 or qs.shape != ts.shape:
        raise ValueError("qs and ts must be [B, L] of one shape")
    B, L = qs.shape
    ql = np.ascontiguousarray(qlens, dtype=np.int64)
    tl = np.ascontiguousarray(tlens, dtype=np.int64)
    ka = np.ascontiguousarray(ks, dtype=np.int64)
    if not (ql.shape == tl.shape == ka.shape == (B,)):
        raise ValueError("qlens, tlens and ks must have B entries")
    if B and (max(int(ql.max()), int(tl.max())) > L
              or min(int(ql.min()), int(tl.min())) < 0):
        raise ValueError("a length lies outside the rows")
    out = np.empty(B, dtype=np.int64)
    if B:
        get_lib("myers_ed").myers_ed_batch_k(
            qs.ctypes.data, ql.ctypes.data, ts.ctypes.data, tl.ctypes.data,
            L, B, ka.ctypes.data, _nthreads(), out.ctypes.data)
    return out
