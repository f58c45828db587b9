"""The control and the faults the ``correct`` comparison must catch.

None of these runs in the benchmark's own runs: ``control.py`` runs them
on the card at a cell's own size, and ``tests/`` at a small size on the
CPU.  Each is a context manager that breaks the timed path underneath the
harness while it is open.

* ``control``: distances that saturate at the caller's cap.  The
  configurations state exact distances under each caller's cap, "above
  the cap" (-1) where the distance exceeds it (edlib's ``k``); the
  control reports the cap there instead, as a kernel that stops counting
  at the cap would: the step a later change might be tempted to take.
* ``ed_altered``: every seventh edit distance of a call, where it has
  one, comes out one higher than computed.
* ``ed_half``: the second half of every call's pairs is left out and
  answered -1 ("above the cap").
* ``align_altered``: every seventh alignment of a call reports one
  mismatch more than it holds.
* ``output_altered``: in each job, one final candidate (the first by
  accession) is written to ``final_candidates.fa`` with its middle base
  changed.
"""
from __future__ import annotations

import contextlib
import functools
import inspect

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _wrap(method, after):
    from isocon_tpu_torch.ops.engine import PairEngine

    orig = getattr(PairEngine, method)

    @functools.wraps(orig)
    def wrapped(engine, *args, **kwargs):
        return after(orig(engine, *args, **kwargs))

    with _patched(PairEngine, method, wrapped):
        yield


def _saturated(call):
    """``edit_distances`` with its "above the cap" answers as the cap."""
    @functools.wraps(call)
    def wrapped(engine, *args, **kwargs):
        ed, ej = call(engine, *args, **kwargs)
        bound = inspect.signature(call).bind(engine, *args, **kwargs)
        bound.apply_defaults()
        caps = bound.arguments.get("k_cap")
        if caps is None:
            return ed, ej
        ed = np.array(ed)
        over = ed < 0
        ed[over] = np.asarray(caps, dtype=np.int64)[over]
        return ed, ej
    return wrapped


def _ed_altered(res):
    ed, ej = res
    ed = np.array(ed)
    pick = np.zeros(ed.shape, dtype=bool)
    pick[::7] = True
    ed[pick & (ed >= 0)] += 1
    return ed, ej


def _ed_half(res):
    ed, ej = res
    ed = np.array(ed)
    ed[(len(ed) + 1) // 2:] = -1
    return ed, ej


def _align_altered(out):
    out = list(out)
    for i in range(0, len(out), 7):
        a1, a2, (ma, mi, ind) = out[i]
        out[i] = (a1, a2, (ma, mi + 1, ind))
    return out


def _output_altered(write):
    """The final ``print_candidates`` with one candidate's middle base
    changed."""
    @functools.wraps(write)
    def wrapped(out, C, *args, final=False, **kwargs):
        if final and C:
            C = dict(C)
            acc = min(C)
            seq = C[acc]
            mid = len(seq) // 2
            if seq:
                base = "C" if seq[mid] == "A" else "A"
                C[acc] = seq[:mid] + base + seq[mid + 1:]
        return write(out, C, *args, final=final, **kwargs)
    return wrapped


def fault(mode: str):
    """The context manager of ``mode``: ``control``, ``ed_altered``,
    ``ed_half``, ``align_altered`` or ``output_altered``."""
    if mode == "control":
        from isocon_tpu_torch.ops.engine import PairEngine
        return _patched(PairEngine, "edit_distances",
                        _saturated(PairEngine.edit_distances))
    if mode == "ed_altered":
        return _wrap("edit_distances", _ed_altered)
    if mode == "ed_half":
        return _wrap("edit_distances", _ed_half)
    if mode == "align_altered":
        return _wrap("align_pairs", _align_altered)
    if mode == "output_altered":
        from isocon_tpu_torch.pipeline import stat_filter
        return _patched(stat_filter, "print_candidates",
                        _output_altered(stat_filter.print_candidates))
    raise ValueError("unknown mode %r" % mode)
