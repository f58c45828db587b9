"""What the benchmark records around the engine's calls.

``Recorder.install(engine_class)`` wraps ``PairEngine.edit_distances``
and ``PairEngine.align_pairs`` (their ``_idx`` forms call them) for the
life of a ``with`` block.  Each call runs inside a profiler span of the
benchmark's own (``portbench.ed_nw``, ``portbench.ed_hw``,
``portbench.align``), so that a trace can name what the host did while
the card waited.  Around each call it keeps

* a sample of the call's pairs and answers for the ``correct``
  comparison: per route (NW distances, HW distances, alignments) a
  reservoir of a fixed size over every pair the window's jobs computed,
  each pair drawn with a key from the run's seed;
* with ``keep_all``, every pair's lengths, cap and answer (for
  alignments the answers themselves), for the roofline counts.

Only the sampled pairs' strings are copied; the rest is numpy.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import math
from typing import Dict, List

import numpy as np
from torch.profiler import record_function

ROUTES = ("ed_nw", "ed_hw", "align")
UNCAPPED = 2 ** 31 - 1


class Reservoir:
    """A uniform sample of ``size`` of all the items offered (Li's
    algorithm L: the skips between admitted items are drawn, so a call
    costs the items it admits, not the items it offers)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.items: List[tuple] = []
        self.offered = 0
        self._w = 0.0
        self._next = 0          # index of the next item to admit

    def _u(self) -> float:
        return 1.0 - self.rng.random()          # in (0, 1]

    def _skip(self) -> int:
        return int(math.floor(math.log(self._u()) / math.log1p(-self._w)))

    def offer(self, n: int, fetch) -> None:
        """Offer n items; ``fetch(i)`` gives item i of them, called only
        for those admitted."""
        base = self.offered
        self.offered += n
        i = 0
        while len(self.items) < self.size and i < n:
            self.items.append(fetch(i))
            i += 1
            if len(self.items) == self.size:
                self._w = math.exp(math.log(self._u()) / self.size)
                self._next = base + i + self._skip()
        if len(self.items) < self.size:
            return
        while self._next < self.offered:
            slot = int(self.rng.integers(self.size))
            self.items[slot] = fetch(self._next - base)
            self._w *= math.exp(math.log(self._u()) / self.size)
            self._next += self._skip() + 1


class Recorder:
    def __init__(self, seed: int, sample_sizes: Dict[str, int],
                 keep_all: bool = False):
        rng = np.random.default_rng([seed % 2 ** 64, 0x5EED])
        self.samples = {r: Reservoir(int(sample_sizes.get(r, 0)), rng)
                        for r in ROUTES}
        self.keep_all = keep_all
        self.ed_calls: Dict[str, list] = {"ed_nw": [], "ed_hw": []}
        self.align_calls: list = []
        self.active = True

    def _ed(self, orig, engine, args, kwargs):
        arg = _bind(orig, engine, args, kwargs)
        pairs = arg["pairs"]
        hw_mode = bool(arg.get("hw_mode"))
        route = "ed_hw" if hw_mode else "ed_nw"
        with record_function("portbench." + route):
            ed, ej = orig(engine, *args, **kwargs)
        if not self.active:
            return ed, ej
        n = len(pairs)
        k_cap = arg.get("k_cap")
        caps = (np.asarray(k_cap, dtype=np.int64) if k_cap is not None
                else np.full(n, UNCAPPED, dtype=np.int64))

        def fetch(i):
            a, b = pairs[i]
            return a, b, int(caps[i]), int(ed[i]), int(ej[i])

        self.samples[route].offer(n, fetch)
        if self.keep_all:
            la, lb = _lengths(pairs, arg.get("lens"))
            self.ed_calls[route].append(
                (la, lb, caps.copy(), np.asarray(ed, dtype=np.int64).copy()))
        return ed, ej

    def _align(self, orig, engine, args, kwargs):
        arg = _bind(orig, engine, args, kwargs)
        pairs, scores = arg["pairs"], arg["scores"]
        with record_function("portbench.align"):
            out = orig(engine, *args, **kwargs)
        if not self.active:
            return out

        def fetch(i):
            a, b = pairs[i]
            return a, b, tuple(int(x) for x in scores[i]), out[i]

        self.samples["align"].offer(len(pairs), fetch)
        if self.keep_all:
            la, lb = _lengths(pairs, arg.get("lens"))
            self.align_calls.append((la, lb, out))
        return out

    @contextlib.contextmanager
    def install(self, engine_class):
        """Wrap ``engine_class``'s two entries while the block runs."""
        ed_orig = engine_class.edit_distances
        al_orig = engine_class.align_pairs
        rec = self

        @functools.wraps(ed_orig)
        def edit_distances(engine, *args, **kwargs):
            return rec._ed(ed_orig, engine, args, kwargs)

        @functools.wraps(al_orig)
        def align_pairs(engine, *args, **kwargs):
            return rec._align(al_orig, engine, args, kwargs)

        engine_class.edit_distances = edit_distances
        engine_class.align_pairs = align_pairs
        try:
            yield self
        finally:
            engine_class.edit_distances = ed_orig
            engine_class.align_pairs = al_orig


def _bind(fn, engine, args, kwargs) -> dict:
    """The call's arguments by name, defaults filled in."""
    bound = inspect.signature(fn).bind(engine, *args, **kwargs)
    bound.apply_defaults()
    return bound.arguments


def _lengths(pairs, lens):
    if lens is not None:
        return (np.array(lens[0], dtype=np.int64),
                np.array(lens[1], dtype=np.int64))
    n = len(pairs)
    return (np.fromiter((len(p[0]) for p in pairs), np.int64, n),
            np.fromiter((len(p[1]) for p in pairs), np.int64, n))
