"""Phase 2's read alignments as arrays, each converted once.

A read's alignment to its candidate changes only when the read is
reassigned, yet the tests read it once for every edge that touches its
candidate, in every round that retests the edge.  The store turns each
alignment tuple ``(aln_ref, aln_read, stats)`` into arrays once:

* its two rows as ``uint8``, in two flat buffers with offsets (no padding,
  so 16.6 kb rows cost no more than their length);
* the reference row's coordinate map: the alignment column of each
  position of the reference, in one flat ``int32`` buffer;
* the read's (insertions, deletions, substitutions) against the reference,
  end gap runs excluded (``alnutils.read_errors_from_alignment``).

Entries are keyed by the tuple itself: the store holds it, so its ``id``
names no other object while the entry lives.  A reassigned read arrives as
a new tuple and is converted anew.  ``retain`` drops the entries of
alignments that left the partition.

Counters (the engine's): ``stat_rows_built``, alignments converted;
``stat_rows_used``, (read, edge) uses served by ``rows``.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

_DASH = np.uint8(ord("-"))


class AlignmentStore:
    def __init__(self, counters=None):
        self.counters = ({"stat_rows_built": 0, "stat_rows_used": 0}
                         if counters is None else counters)
        self._row: Dict[int, int] = {}   # id(alignment) -> row
        self._held: list = []            # row -> alignment, None once dropped
        self.ref = np.zeros(0, np.uint8)
        self.read = np.zeros(0, np.uint8)
        self.start = np.zeros(0, np.int64)      # row -> its first column
        self.length = np.zeros(0, np.int64)
        self.cmap = np.zeros(0, np.int32)
        self.cmap_start = np.zeros(0, np.int64)
        self.cmap_len = np.zeros(0, np.int64)
        self.errors = np.zeros((0, 3), np.int64)  # ins, del, subs

    def add(self, alignments: Iterable[tuple]) -> None:
        """Convert, in one pass, the alignments the store lacks."""
        new = {}
        for aln in alignments:
            if id(aln) not in self._row:
                new[id(aln)] = aln
        if not new:
            return
        refs = [a[0] for a in new.values()]
        reads = [a[1] for a in new.values()]
        lens = np.fromiter(map(len, refs), np.int64, len(refs))
        if not np.array_equal(lens, np.fromiter(map(len, reads), np.int64,
                                                len(reads))):
            raise ValueError("an alignment's rows differ in length")
        ref = np.frombuffer("".join(refs).encode("latin1"), np.uint8)
        read = np.frombuffer("".join(reads).encode("latin1"), np.uint8)
        ends = np.cumsum(lens)
        starts = ends - lens
        ref_gap = ref == _DASH
        read_gap = read == _DASH
        # the columns between both rows' end gap runs
        cols_ref = np.flatnonzero(~ref_gap)
        cmap_start, cmap_end = (np.searchsorted(cols_ref, starts),
                                np.searchsorted(cols_ref, ends))
        first_ref, last_ref = _first_last(cols_ref, cmap_start, cmap_end,
                                          starts, lens)
        cols_read = np.flatnonzero(~read_gap)
        first_read, last_read = _first_last(
            cols_read, np.searchsorted(cols_read, starts),
            np.searchsorted(cols_read, ends), starts, lens)
        lo = starts + np.maximum(first_ref, first_read)
        hi = np.maximum(starts + np.minimum(last_ref, last_read) + 1, lo)
        diff = ref != read
        errors = np.stack([_window_counts(diff & ref_gap, lo, hi),
                           _window_counts(diff & read_gap, lo, hi),
                           _window_counts(diff, lo, hi)], axis=1)
        errors[:, 2] -= errors[:, 0] + errors[:, 1]
        cmap_len = cmap_end - cmap_start
        cmap = (cols_ref - np.repeat(starts, cmap_len)).astype(np.int32)

        first = len(self._held)
        self._row.update(zip(new, range(first, first + len(new))))
        self._held.extend(new.values())
        self.start = np.concatenate([self.start, starts + self.ref.size])
        self.length = np.concatenate([self.length, lens])
        self.cmap_start = np.concatenate([self.cmap_start,
                                          cmap_start + self.cmap.size])
        self.cmap_len = np.concatenate([self.cmap_len, cmap_len])
        self.ref = np.concatenate([self.ref, ref])
        self.read = np.concatenate([self.read, read])
        self.cmap = np.concatenate([self.cmap, cmap])
        self.errors = np.concatenate([self.errors, errors])
        self.counters["stat_rows_built"] += len(new)

    def rows(self, alignments: dict) -> np.ndarray:
        """The rows of ``alignments.values()``, in order; counts a use each."""
        index = self._row
        rows = np.fromiter((index[id(a)] for a in alignments.values()),
                           np.int64, len(alignments))
        self.counters["stat_rows_used"] += len(rows)
        return rows

    def coord_map(self, row: int) -> np.ndarray:
        s = self.cmap_start[row]
        return self.cmap[s:s + self.cmap_len[row]]

    def columns(self, rows: np.ndarray, pos: int) -> np.ndarray:
        """The alignment column of reference position ``pos`` in each row."""
        if (self.cmap_len[rows] <= pos).any():
            raise IndexError("position %d past a reference row" % pos)
        return self.cmap[self.cmap_start[rows] + pos].astype(np.int64)

    def retain(self, read_partition: Dict[str, dict]) -> None:
        """Drop the entries of alignments no longer in ``read_partition``;
        compact the buffers once the dropped rows outnumber the others."""
        live = {id(a) for reads in read_partition.values()
                for a in reads.values()}
        for key in [k for k in self._row if k not in live]:
            self._held[self._row.pop(key)] = None
        if 2 * len(self._row) >= len(self._held):
            return
        keep = np.array([a is not None for a in self._held], dtype=bool)
        new_row = np.cumsum(keep) - 1
        self._row = {k: int(new_row[r]) for k, r in self._row.items()}
        self._held = [a for a in self._held if a is not None]
        col_keep = np.repeat(keep, self.length)
        self.ref = self.ref[col_keep]
        self.read = self.read[col_keep]
        self.cmap = self.cmap[np.repeat(keep, self.cmap_len)]
        self.length = self.length[keep]
        self.cmap_len = self.cmap_len[keep]
        self.start = np.cumsum(self.length) - self.length
        self.cmap_start = np.cumsum(self.cmap_len) - self.cmap_len
        self.errors = self.errors[keep]


def _first_last(cols, at_start, at_end, starts, lens):
    """Each row's first and last column in ``cols`` (sorted flat columns;
    ``at_start``, ``at_end``: where each row's columns begin and end in
    it), relative to the row: (its length, -1) where it has none."""
    has = at_end > at_start
    if not has.any():
        return lens, np.full(lens.size, -1, np.int64)
    first = np.where(has, cols[np.minimum(at_start, cols.size - 1)] - starts,
                     lens)
    last = np.where(has, cols[np.maximum(at_end - 1, 0)] - starts, -1)
    return first, last


def _window_counts(mask: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Set entries of ``mask`` in each flat window [lo, hi)."""
    at = np.flatnonzero(mask)
    return np.searchsorted(at, hi) - np.searchsorted(at, lo)
