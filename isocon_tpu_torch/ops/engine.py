"""Host side of the batched DP kernels (counterpart of
``isocon_tpu/ops/engine.py``).

Every call runs on the engine's sequence table: a sequence gets one table
id (``add_seqs``) and, through a row map per padded length, one row of the
device-resident pool of that length (a uint8 [R, L] tensor, its lengths
and its Peq planes); batches then carry only int32 row indices.  Edit
distances run the banded Myers kernel (K1, or K2 in HW / infix mode) and
certify each result against its window; uncertified pairs escalate to
wider windows (7, 9, 17, 33 words for bands 128 .. 1024) and past that to
the full-width window, which is exact.  Pools wider than MYERS_MAX_L
(reads longer than 16,384 bases) run the banded wavefront kernel (K5)
instead, NW and HW, doubling the band from 128 lanes until the result
certifies.  Alignments run the
affine forward (K3) and walk (K4) kernels in a band chosen from the edit
distance and double the band on overflow.  K4 also writes each pair's two
aligned strings and counts, which the host slices out of one decoded
string a batch.  The kernels read codes, and the code of a base does not
give back its letter (``encode_seq`` maps lowercase to the upper-case
codes and every other letter to one code), so the pool marks each row
whose string holds only A, C, G, T and N; a pair with another row has
its sliced rows spelt with its own letters and its counts taken again on
the host (``affine.respell_rows``).

Results depend only on the exact edit distance and the caller's cap, so
the decisions equal the JAX engine's whatever the window ladder.

Every kernel batch (K1/K2, K5, K3 + K4) goes through a
``parallel.Sharder``: by default one block on the engine's device, or a
mesh's blocks, each on its device.  The pools live on the sharder's first
device of this process, where the sketch (K6) runs unsharded.  The
counters count the caller's pairs, never the sharder's padding, so the
engine volume is the unsharded run's.  A round's batches are all launched
before the first is collected, and they are collected in launch order:
every batch has a block on each device of the mesh, and each device runs
its blocks on one stream, so a batch never completes before an earlier
one.

On the CPU, without a sharder from the caller, edit distances take the
host C++ route instead (``native_cpu``, as the JAX engine's CPU backend):
threaded full-width Myers for NW (``native/myers_ed.cc``) and the banded
HW traceback for HW mode (``native/hw_traceback.cc``); the results are the
same exact distances.  ``ISOCON_NO_NATIVE=1`` keeps the plain K1/K2/K5.
Alignments always run the banded K3/K4 (their plain versions on the CPU).
"""
from __future__ import annotations

import codecs
import os
import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from . import oracle
from .affine import BandOverflow, respell_rows
from .encode import encode_seq
from .affine_cuda import fetch, sg_align_pool
from .myers import (myers_certifies, myers_certifies_hw, myers_ed_pool,
                    myers_hw_pool, peq_table)
from .wavefront import SMALL_WP, band_certifies, banded_ed_pool
from ..parallel.sharding import Sharder, upload

# Band width -> Myers window words (certification radius 32*(win//2));
# wider bands run the full-width window
_MYERS_WIN = {128: 7, 256: 9, 512: 17, 1024: 33}
# Widest pool the Myers kernels take (the full-width window holds 512
# words); wider pools run the banded wavefront (K5) at every band
MYERS_MAX_L = 16384

POOL_L_MIN = 256          # smallest padded pool width
W0 = 128                  # first ED band (Myers window 7)
ED_BATCH = 262144         # pairs per K1 / K2 launch
WAVE_BATCH = 16384        # pairs per K5 launch (one warp a pair at Wp <= 1024)
ALIGN_BATCH = 8192        # pairs per K3/K4 launch ...
ALIGN_SCRATCH_BYTES = 16e9  # ... capped by the K3 direction scratch
PEQ_CHUNK_ROWS = 8192
# the strings whose pool rows give them back letter for letter
_EXACT = re.compile(r"[ACGTN]*")


def _nbytes(arrays) -> int:
    return sum(a.nbytes for a in arrays)


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for the engine: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the plain CPU versions")
    return dev


def _pool_widths(ln: np.ndarray) -> np.ndarray:
    """Padded pool width per pair: the power of two >= the longer
    sequence, at least POOL_L_MIN."""
    w = np.left_shift(1, np.ceil(np.log2(np.maximum(ln, 1))).astype(np.int64))
    return np.maximum(POOL_L_MIN, w)


def pool_from_numpy(pool_flat: np.ndarray, plen: np.ndarray, L: int,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX pool layout (flat int8 [U*L] codes plus lengths [U]) as the
    port's pool tensors: (uint8 [U, L], int32 [U]) on ``device``."""
    flat = np.ascontiguousarray(pool_flat).view(np.uint8)
    U = flat.shape[0] // L
    mat = torch.from_numpy(flat.reshape(U, L).copy()).to(device)
    lens = torch.from_numpy(np.asarray(plen, dtype=np.int32).copy()).to(device)
    return mat, lens


class _SeqPool:
    """Device-resident sequence pool for one padded length: an append-only
    store whose rows the engine's table-id row maps assign (one row a
    sequence).

    Row 0 is a length-1 sentinel.  New rows collect on the host and reach
    the device in one copy per ``tensors()`` call, with their Peq planes
    computed there.  On a card the copy is queued from pinned memory and
    does not wait for the stream.  ``with_peq=False`` (pools the Myers
    kernels never read) keeps no planes: ``peq`` is an empty tensor.
    ``exact[r]``: row r's string holds only A, C, G, T and N, so K4's rows
    spell it.  ``counters``: the engine's, whose ``upload_bytes`` counts
    the rows and lengths sent."""

    def __init__(self, L: int, device: torch.device, counters: dict,
                 min_rows: int = 0, with_peq: bool = True):
        self.L = L
        self.device = device
        self.counters = counters
        self._peq_words = L // 32 if with_peq else 0
        self.n = 1
        self._dev_rows = 1
        self._pending: List[np.ndarray] = []
        cap = max(1024, int(min_rows))
        self.mat = torch.full((cap, L), 6, dtype=torch.uint8, device=device)
        self.lens = torch.ones(cap, dtype=torch.int32, device=device)
        self.peq = torch.zeros((cap, 5, self._peq_words), dtype=torch.int32,
                               device=device)
        self.exact = np.zeros(cap, dtype=bool)

    def append(self, seq: str) -> int:
        """A new row holding ``seq``; returns its index."""
        self._pending.append(encode_seq(seq))
        r = self.n
        if r == self.exact.size:
            self.exact = np.concatenate([self.exact, np.zeros_like(
                self.exact)])
        self.exact[r] = _EXACT.fullmatch(seq) is not None
        self.n += 1
        return r

    def _grow(self, cap: int):
        old = self.mat.shape[0]
        mat = torch.full((cap, self.L), 6, dtype=torch.uint8,
                         device=self.device)
        lens = torch.ones(cap, dtype=torch.int32, device=self.device)
        peq = torch.zeros((cap, 5, self._peq_words), dtype=torch.int32,
                          device=self.device)
        mat[:old] = self.mat
        lens[:old] = self.lens
        peq[:old] = self.peq
        self.mat, self.lens, self.peq = mat, lens, peq

    def tensors(self):
        """(mat, lens, peq) covering every interned row."""
        if self._pending:
            k = len(self._pending)
            r0 = self._dev_rows
            if self.n > self.mat.shape[0]:
                cap = self.mat.shape[0]
                while cap < self.n:
                    cap *= 2
                self._grow(cap)
            block = np.full((k, self.L), 6, dtype=np.uint8)
            lens = np.empty(k, dtype=np.int32)
            for x, e in enumerate(self._pending):
                block[x, : len(e)] = e.view(np.uint8)
                lens[x] = len(e)
            self.mat[r0:r0 + k] = upload(block, self.device)
            self.lens[r0:r0 + k] = upload(lens, self.device)
            self.counters["upload_bytes"] += block.nbytes + lens.nbytes
            if self._peq_words:
                for s in range(r0, r0 + k, PEQ_CHUNK_ROWS):
                    e = min(s + PEQ_CHUNK_ROWS, r0 + k)
                    self.peq[s:e] = peq_table(self.mat[s:e], self.lens[s:e])
            self._pending = []
            self._dev_rows = self.n
        return self.mat[: self.n], self.lens[: self.n], self.peq[: self.n]


class _HostPool:
    """Host-side sequence pool of the CPU route (the JAX engine's
    ``_HostPool``), append-only like ``_SeqPool``: each sequence encodes
    once into a growing [cap, width] uint8 matrix, and a batch is one numpy
    row gather.  The host library reads only each row's length prefix."""

    def __init__(self):
        self.mat = np.empty((1024, 256), dtype=np.uint8)
        self.lens = np.zeros(1024, dtype=np.int64)
        self.n = 0

    def append(self, seq: str) -> int:
        """A new row holding ``seq``; returns its index."""
        e = encode_seq(seq).view(np.uint8)
        cap, width = self.mat.shape
        if len(e) > width:
            w = max(256, 1 << int(len(e) - 1).bit_length())
            mat = np.empty((cap, w), dtype=np.uint8)
            mat[:, :width] = self.mat
            self.mat = mat
            width = w
        if self.n == cap:
            mat = np.empty((2 * cap, width), dtype=np.uint8)
            mat[:cap] = self.mat
            self.mat = mat
            lens = np.zeros(2 * cap, dtype=np.int64)
            lens[:cap] = self.lens
            self.lens = lens
        self.mat[self.n, : len(e)] = e
        self.lens[self.n] = len(e)
        self.n += 1
        return self.n - 1


class _PairView:
    """Lazy (a, b) tuple view over engine-table index arrays."""

    __slots__ = ("seqs", "ia", "ib")

    def __init__(self, seqs, ia, ib):
        self.seqs = seqs
        self.ia = ia
        self.ib = ib

    def __len__(self):
        return self.ia.shape[0]

    def __getitem__(self, i):
        return self.seqs[self.ia[i]], self.seqs[self.ib[i]]


class PairEngine:
    """Batched exact edit distances and affine alignments over pair lists.

    Two call surfaces, as in the JAX engine: string pairs
    (``edit_distances`` / ``align_pairs``) and engine-table indices
    (``add_seqs`` + ``edit_distances_idx`` / ``align_pairs_idx``).  The
    index forms call the string forms with the table's ids, and a string
    call registers its strings, so every call passes through the two
    string entries and ends in one body on table ids.
    ``device``: where the pools live and the kernels run (default CUDA;
    ``"cpu"`` runs the kernels' plain versions).  ``sharder``: a
    ``parallel.Sharder`` that runs every kernel batch over its mesh; the
    engine's device is then the sharder's (``device`` may name its type).
    Without one the engine makes a Sharder of its own device.

    ``native_cpu`` (a plain attribute, which tests may set): edit
    distances take the host C++ route.  It is on when the device is the
    CPU, the caller passed no sharder and ``ISOCON_NO_NATIVE`` is unset;
    on a card it is always off.
    """

    def __init__(self, device=None, sharder=None):
        if sharder is not None:
            if (device is not None
                    and torch.device(device).type != sharder.device.type):
                raise ValueError("device %s is not the sharder's %s"
                                 % (device, sharder.device))
            device = sharder.device
        self.device = resolve_device(device)
        self.native_cpu = (self.device.type == "cpu" and sharder is None
                           and not os.environ.get("ISOCON_NO_NATIVE"))
        self.sharder = sharder or Sharder([self.device])
        self._host_pool = _HostPool()
        self._tab_host_rows: Optional[np.ndarray] = None
        self._pools: dict = {}
        self._pool_reserve = 0
        self._tab_seqs: List[str] = []
        self._tab_ids: dict = {}
        self._tab_lens = np.zeros(0, dtype=np.int64)
        self._tab_pool_rows: dict = {}
        self.counters = {
            "ed_calls": 0, "ed_pairs": 0, "ed_seconds": 0.0,
            "align_calls": 0, "align_pairs": 0, "align_seconds": 0.0,
            # pairs past the 33-word window, run by the full-width window
            "ed_pairs_full_window": 0,
            # pairs run by the banded wavefront (pools above MYERS_MAX_L),
            # and those runs that ran a pair again at a doubled band after
            # its answer failed to certify
            "ed_pairs_wavefront": 0, "wave_pairs_rerun": 0,
            # alignments re-run in a doubled band after a band overflow
            "align_overflows": 0,
            # pairs under the HW prefilter's cutoff that went to the host
            # traceback of the ends-ignored candidate graph, and its time
            "hw_survivors": 0, "hw_traceback_seconds": 0.0,
            # rows the sketch of --nontargeted scored, and its time; of
            # that time the k-mer profiles' (the bytes' join and upload and
            # K7's launch); the rows whose profiles K7 built on the card;
            # the distinct scores a top-n over every pair weighs
            # (n(n - 1)/2 a call); the pairs its candidates sent to the
            # exact rescoring
            "sketch_rows": 0, "sketch_seconds": 0.0,
            "sketch_profile_seconds": 0.0, "sketch_profile_card_rows": 0,
            "sketch_score_cells": 0, "sketch_pairs": 0,
            # parts of ed_seconds and align_seconds: the host clock around
            # each batch's collect (the fetch and its wait for the device),
            # and around each alignment batch's decode loop; the part of
            # ed_wait_seconds that the banded wavefront's collects take
            "ed_wait_seconds": 0.0, "align_wait_seconds": 0.0,
            "align_decode_seconds": 0.0, "wave_wait_seconds": 0.0,
            # alignments whose strings and counts are K4's rows as the
            # card wrote them, and those whose rows the host spelt again
            # with the pair's letters (a side whose letters the codes do
            # not give back)
            "align_card_rows": 0, "align_host_rows": 0,
            # bytes of the host arrays the collects returned, and of the
            # caller's arrays sent to the device through
            # ``parallel.sharding.upload`` (pool rows and lengths, index and
            # score vectors; never the sharder's padding)
            "fetch_bytes": 0, "upload_bytes": 0,
            # MAM correction's member rows: those of the dense partitions,
            # which the consensus chain votes on (``correct.dense.
            # correct_round``), and those of the other partitions of more
            # than one member, which the host takes
            "consensus_rows_card": 0, "consensus_rows_host": 0,
            # phase 2's tests: read alignments turned into arrays
            # (``stats/store.py``), and the (read, edge) uses those arrays
            # served
            "stat_rows_built": 0, "stat_rows_used": 0,
        }

        # (mode, band width) -> pairs the banded wavefront ran there
        self.wavefront_rungs: dict = {}
        # (mode, window words; 0 = the full width) -> pairs the Myers
        # kernels ran there
        self.myers_rungs: dict = {}

    def stats_line(self) -> str:
        c = self.counters
        return (
            "engine: %d EDs in %.1fs (%d calls, %d full-window, "
            "%d wavefront, %d of them reruns, %.1fs of wavefront waits), "
            "%d alignments in %.1fs (%d calls; %d card rows, "
            "%d host rows); MAM rows: %d consensus chain, %d host; "
            "test rows: %d built, %d used; sketch: %d rows in %.1fs "
            "(%.1fs profiles, %d rows on the card), %d scores, "
            "%d rescoring pairs" % (
                c["ed_pairs"], c["ed_seconds"], c["ed_calls"],
                c["ed_pairs_full_window"], c["ed_pairs_wavefront"],
                c["wave_pairs_rerun"], c["wave_wait_seconds"],
                c["align_pairs"], c["align_seconds"], c["align_calls"],
                c["align_card_rows"], c["align_host_rows"],
                c["consensus_rows_card"], c["consensus_rows_host"],
                c["stat_rows_built"], c["stat_rows_used"],
                c["sketch_rows"], c["sketch_seconds"],
                c["sketch_profile_seconds"], c["sketch_profile_card_rows"],
                c["sketch_score_cells"], c["sketch_pairs"],
            )
        )

    def reserve_pool_rows(self, n: int) -> None:
        """Initial row capacity of pools created after this call (callers
        pass ~4x the unique-read count of a run)."""
        self._pool_reserve = max(self._pool_reserve, int(n))

    def _get_pool(self, Lb: int) -> _SeqPool:
        pool = self._pools.get(Lb)
        if pool is None:
            pool = self._pools[Lb] = _SeqPool(
                Lb, self.device, self.counters, self._pool_reserve,
                with_peq=Lb <= MYERS_MAX_L)
        return pool

    # ------------------------------------------------------------------
    # engine-owned sequence table (index API)
    # ------------------------------------------------------------------
    def add_seqs(self, seqs: Sequence[str]) -> np.ndarray:
        """Register sequences; returns their int32 ids (duplicates map to
        the same id)."""
        ids = np.empty(len(seqs), dtype=np.int32)
        tab_ids = self._tab_ids
        tab_seqs = self._tab_seqs
        new_lens = []
        for pos, s in enumerate(seqs):
            i = tab_ids.get(s)
            if i is None:
                i = tab_ids[s] = len(tab_seqs)
                tab_seqs.append(s)
                new_lens.append(len(s))
            ids[pos] = i
        if new_lens:
            self._tab_lens = np.concatenate(
                [self._tab_lens, np.asarray(new_lens, dtype=np.int64)])
        return ids

    def table_lens(self, ids: np.ndarray) -> np.ndarray:
        """Sequence lengths for engine-table ids (int64)."""
        return self._tab_lens[np.asarray(ids, dtype=np.int64)]

    def _grown_rowmap(self, rm: Optional[np.ndarray], dtype) -> np.ndarray:
        """A table-id -> row map covering every table id (-1: not yet
        interned), ``rm`` itself while it is large enough."""
        n = len(self._tab_seqs)
        if rm is None or rm.size < n:
            new = np.full(max(1024, 2 * n), -1, dtype=dtype)
            if rm is not None:
                new[: rm.size] = rm
            return new
        return rm

    def _pool_rows_for(self, pool, Lb: int, ids: np.ndarray) -> np.ndarray:
        """Table ids -> pool rows for bucket Lb (appending the misses)."""
        rm = self._tab_pool_rows[Lb] = self._grown_rowmap(
            self._tab_pool_rows.get(Lb), np.int32)
        rows = rm[ids]
        if (rows < 0).any():
            seqs, append = self._tab_seqs, pool.append
            for tid in np.unique(ids[rows < 0]).tolist():
                rm[tid] = append(seqs[tid])
            rows = rm[ids]
        return rows.astype(np.int32, copy=False)

    def _host_rows_for(self, ids: np.ndarray) -> np.ndarray:
        """Table ids -> host-pool rows (the CPU route's batch assembly)."""
        rm = self._tab_host_rows = self._grown_rowmap(self._tab_host_rows,
                                                      np.int64)
        rows = rm[ids]
        if (rows < 0).any():
            seqs, append = self._tab_seqs, self._host_pool.append
            for tid in np.unique(ids[rows < 0]).tolist():
                rm[tid] = append(seqs[tid])
            rows = rm[ids]
        return rows

    def _register(self, pairs) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                        Tuple[np.ndarray, np.ndarray]]:
        """A string call's table ids and lengths, (ia, ib), (la, lb)."""
        ia = self.add_seqs([p[0] for p in pairs]).astype(np.int64)
        ib = self.add_seqs([p[1] for p in pairs]).astype(np.int64)
        return (ia, ib), (self._tab_lens[ia], self._tab_lens[ib])

    def edit_distances_idx(self, ia: np.ndarray, ib: np.ndarray,
                           k_cap: Optional[Sequence[int]] = None,
                           hw_mode: bool = False):
        """``edit_distances`` over engine-table indices (see add_seqs)."""
        ia = np.ascontiguousarray(ia, dtype=np.int64)
        ib = np.ascontiguousarray(ib, dtype=np.int64)
        return self.edit_distances(
            _PairView(self._tab_seqs, ia, ib), k_cap=k_cap, hw_mode=hw_mode,
            lens=(self._tab_lens[ia], self._tab_lens[ib]), _idx=(ia, ib))

    def align_pairs_idx(self, ia: np.ndarray, ib: np.ndarray,
                        scores: Sequence[Tuple[int, int, int, int]],
                        ed_hint: Optional[Sequence[int]] = None):
        """``align_pairs`` over engine-table indices."""
        ia = np.ascontiguousarray(ia, dtype=np.int64)
        ib = np.ascontiguousarray(ib, dtype=np.int64)
        return self.align_pairs(
            _PairView(self._tab_seqs, ia, ib), scores, ed_hint=ed_hint,
            lens=(self._tab_lens[ia], self._tab_lens[ib]), _idx=(ia, ib))

    # ------------------------------------------------------------------
    def edit_distances(
        self,
        pairs: Sequence[Tuple[str, str]],
        k_cap: Optional[Sequence[int]] = None,
        hw_mode: bool = False,
        lens: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        _idx: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact edit distances for a list of string pairs.

        k_cap[i], when given, reports pair i as -1 once it is certain that
        ed > k_cap[i] (edlib's ``k`` contract).  hw_mode: infix distance
        of a inside b (free target start and end).  Returns (ed int32,
        end_j int32); end_j is len(b) for NW pairs and the exclusive end
        of the target span in hw_mode (meaningful where ed >= 0).  The
        call is the span ``isocon_engine.ed_nw`` (``.ed_hw``) of a
        profiler trace.  ``lens`` and ``_idx``, the pairs' lengths and
        table ids, come from ``edit_distances_idx``; a call without them
        registers its strings (``add_seqs``).  Either way the body runs on
        table ids."""
        with record_function("isocon_engine.ed_hw" if hw_mode
                             else "isocon_engine.ed_nw"):
            t_start = time.perf_counter()
            if _idx is None:
                _idx, lens = self._register(pairs)
            out = self._edit_distances(*_idx, *lens, k_cap, hw_mode)
            self.counters["ed_seconds"] += time.perf_counter() - t_start
            return out

    def _edit_distances(self, ia, ib, la, lb, k_cap, hw_mode):
        """``edit_distances`` of the pairs of table ids (ia[i], ib[i]),
        of lengths (la[i], lb[i])."""
        n_pairs = len(ia)
        ed_out = np.full(n_pairs, -1, dtype=np.int32)
        ej_out = np.zeros(n_pairs, dtype=np.int32)
        if n_pairs == 0:
            return ed_out, ej_out
        self.counters["ed_calls"] += 1
        self.counters["ed_pairs"] += n_pairs
        caps = (np.asarray(k_cap, dtype=np.int64) if k_cap is not None
                else np.full(n_pairs, 2 ** 31 - 1, dtype=np.int64))
        if hw_mode:
            diff_skip = np.zeros(n_pairs, dtype=bool)
        else:
            diff_skip = np.abs(la - lb) > caps  # ed >= |len diff| > cap
        empty = ((la == 0) | (lb == 0)) & ~diff_skip
        for i in np.flatnonzero(empty):
            d = int(max(la[i], lb[i]))
            ed_out[i] = d if d <= caps[i] else -1
            ej_out[i] = 0 if hw_mode else int(lb[i])
            if hw_mode and la[i] == 0:
                ed_out[i] = 0       # an empty query fits an empty span
        rest = np.flatnonzero(~(diff_skip | empty))
        if self.native_cpu and rest.size:
            self._ed_native(ia[rest], ib[rest], rest, caps, hw_mode, ed_out,
                            ej_out)
            return ed_out, ej_out
        certifies = myers_certifies_hw if hw_mode else myers_certifies
        floor_of = self._myers_floor_hw if hw_mode else self._myers_floor
        Wp = W0
        while rest.size:
            win = _MYERS_WIN.get(Wp)          # None: full-width window
            next_round: List[np.ndarray] = []
            ln = np.maximum(la[rest], lb[rest])
            Lb_arr = _pool_widths(ln)
            launched = []
            for Lb in np.unique(Lb_arr).tolist():
                wave = Lb > MYERS_MAX_L
                if wave and Wp > 4 * Lb + 256:
                    raise RuntimeError("band escalation failed to terminate")
                idxs = rest[Lb_arr == Lb]
                pool = self._get_pool(Lb)
                ia_all = self._pool_rows_for(pool, Lb, ia[idxs])
                ib_all = self._pool_rows_for(pool, Lb, ib[idxs])
                mat, plen, peq = pool.tensors()
                L = Lb if win is None else max(Lb, 32 * win)
                step = WAVE_BATCH if wave else ED_BATCH
                for s in range(0, len(idxs), step):
                    sl = slice(s, s + step)
                    vecs = (ia_all[sl], ib_all[sl])
                    if wave:
                        batch = self.sharder.launch(
                            banded_ed_pool, (mat, plen), vecs, Wp=Wp,
                            hw_mode=hw_mode)
                    else:
                        batch = self.sharder.launch(
                            myers_hw_pool if hw_mode else myers_ed_pool,
                            (mat, plen, peq), vecs, L=L, win=win)
                    self.counters["upload_bytes"] += _nbytes(vecs)
                    launched.append((idxs[sl], batch, wave))
            for chunk, batch, wave in launched:
                keys = (("ed_wait_seconds", "wave_wait_seconds") if wave
                        else ("ed_wait_seconds",))
                res = self._collect(batch, *keys)
                if hw_mode or wave:
                    ed, ej = res
                else:
                    ed, = res
                    ej = lb[chunk].astype(np.int32)
                if wave:
                    self.counters["ed_pairs_wavefront"] += len(chunk)
                    if Wp > W0:
                        self.counters["wave_pairs_rerun"] += len(chunk)
                    rung = ("HW" if hw_mode else "NW", Wp)
                    self.wavefront_rungs[rung] = (
                        self.wavefront_rungs.get(rung, 0) + len(chunk))
                    cert = band_certifies(ed, la[chunk], lb[chunk], Wp,
                                          hw_mode=hw_mode,
                                          small=Wp <= SMALL_WP)
                else:
                    rung = ("HW" if hw_mode else "NW", win or 0)
                    self.myers_rungs[rung] = (
                        self.myers_rungs.get(rung, 0) + len(chunk))
                    if win is None:
                        self.counters["ed_pairs_full_window"] += len(chunk)
                        cert = np.ones(len(chunk), dtype=bool)
                    else:
                        cert = certifies(ed, la[chunk], lb[chunk], win=win)
                ci = chunk[cert]
                d = ed[cert].astype(np.int64)
                ed_out[ci] = np.where(d <= caps[ci], d, -1).astype(np.int32)
                ej_out[ci] = ej[cert]
                unc = chunk[~cert]
                if unc.size:
                    # uncertified => true ed exceeds this band's floor;
                    # give up once that clears the caller's cap
                    if wave:
                        floor = self._certified_floor(la[unc], lb[unc], Wp,
                                                      hw_mode)
                    else:
                        floor = floor_of(la[unc], lb[unc], win)
                    give_up = floor >= caps[unc]
                    ed_out[unc[give_up]] = -1
                    next_round.append(unc[~give_up])
            rest = (np.concatenate(next_round) if next_round
                    else np.empty(0, dtype=np.int64))
            Wp *= 2
        return ed_out, ej_out

    def _ed_native(self, ia, ib, idxs, caps, hw_mode, ed_out, ej_out):
        """The CPU route (the JAX engine's ``_ed_native``) for the pairs of
        table ids (ia, ib), at positions ``idxs`` of the call: NW pairs run
        the threaded host Myers with each pair's cap (ej = len(b)); HW pairs
        the host banded traceback from band 64 with their caps (ej = the
        span's exclusive end where ed >= 0)."""
        if hw_mode:
            seqs = self._tab_seqs
            res = native.hw_traceback_batch(
                [(seqs[a], seqs[b]) for a, b in zip(ia.tolist(),
                                                    ib.tolist())],
                band=64, k_cap=caps[idxs])
            for i, (d, _s0, e0, _ops) in zip(idxs.tolist(), res):
                ed_out[i] = d
                ej_out[i] = e0 + 1 if d >= 0 else 0
            return
        hp = self._host_pool
        ra = self._host_rows_for(ia)
        rb = self._host_rows_for(ib)
        ed_out[idxs] = native.myers_ed_batch_k(hp.mat[ra], hp.lens[ra],
                                               hp.mat[rb], hp.lens[rb],
                                               caps[idxs])
        ej_out[idxs] = hp.lens[rb]

    @staticmethod
    def _myers_floor(n: np.ndarray, m: np.ndarray, win: int) -> np.ndarray:
        """Uncertified at window ``win`` implies ed > this (per pair).  If
        delta >= margin the pair can never certify and only ed >= delta is
        known; otherwise every true ed <= 2*margin - delta would have
        certified."""
        margin = 32 * (win // 2)
        delta = np.abs(np.asarray(m, np.int64) - np.asarray(n, np.int64))
        return np.where(delta >= margin, delta - 1, 2 * margin - delta)

    @staticmethod
    def _myers_floor_hw(n: np.ndarray, m: np.ndarray, win: int) -> np.ndarray:
        """HW-mode floor: any true distance <= this would have certified
        under ``myers_certifies_hw``, so uncertified implies ed > floor."""
        margin = 32 * (win // 2)
        over = np.maximum(np.asarray(m, np.int64) - np.asarray(n, np.int64), 0)
        return np.minimum(margin, (margin - over) // 2)

    @staticmethod
    def _certified_floor(n: np.ndarray, m: np.ndarray, Wp: int,
                         hw_mode: bool) -> np.ndarray:
        """Largest v per pair such that any true distance <= v would have
        been certified by ``band_certifies`` at width Wp, so an uncertified
        wavefront result implies ed > floor; -1 where the length difference
        lies outside the band (NW).  The JAX engine's floor, entry for
        entry: it ignores the small band's ceiling (at Wp = 128 it reaches
        127 while nothing at or above 120 certifies), so a pair of distance
        120 .. 127 under a cap up to its floor is given up as -1 there and
        here alike."""
        o_lo = -(Wp // 2 - 1)
        o_hi = o_lo + Wp - 1
        delta = np.asarray(m, np.int64) - np.asarray(n, np.int64)
        if hw_mode:
            return np.minimum(-o_lo, (o_hi - np.maximum(delta, 0)) // 2)
        return np.where((delta > o_hi) | (delta < o_lo), -1,
                        np.minimum(2 * o_hi - delta, -2 * o_lo + delta))

    def _collect(self, batch, *wait_keys: str) -> Tuple[np.ndarray, ...]:
        """``sharder.collect(batch)``, its host seconds added to each of
        ``counters[wait_keys]`` and its bytes to ``fetch_bytes``."""
        t0 = time.perf_counter()
        res = self.sharder.collect(batch)
        secs = time.perf_counter() - t0
        for key in wait_keys:
            self.counters[key] += secs
        self.counters["fetch_bytes"] += _nbytes(res)
        return res

    # ------------------------------------------------------------------
    # affine semi-global alignment with traceback
    # ------------------------------------------------------------------
    def align_pairs(
        self,
        pairs: Sequence[Tuple[str, str]],
        scores: Sequence[Tuple[int, int, int, int]],
        ed_hint: Optional[Sequence[int]] = None,
        lens: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        _idx: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> List[Tuple[str, str, Tuple[int, int, int]]]:
        """Batched semi-global alignments.

        scores: per pair (match, mismatch, gap_open, gap_ext), mismatch
        negative, open/ext positive penalties (parasail convention).
        ed_hint: known edit distance per pair (tightens the initial band).
        Returns (s1_aligned, s2_aligned, (matches, mismatches, indels))
        per pair.  The call is the span ``isocon_engine.align`` of a
        profiler trace.  ``lens`` and ``_idx`` as in ``edit_distances``."""
        with record_function("isocon_engine.align"):
            t_start = time.perf_counter()
            if _idx is None:
                _idx, lens = self._register(pairs)
            out = self._align_pairs(*_idx, *lens, scores, ed_hint)
            self.counters["align_seconds"] += time.perf_counter() - t_start
            return out

    def _align_pairs(self, ia, ib, la, lb, scores, ed_hint):
        """``align_pairs`` of the pairs of table ids (ia[i], ib[i]), of
        lengths (la[i], lb[i])."""
        n_pairs = len(ia)
        self.counters["align_calls"] += 1
        self.counters["align_pairs"] += n_pairs
        seqs = self._tab_seqs
        out: List = [None] * n_pairs
        hostm = np.minimum(la, lb) == 0      # empty side: no kernel call
        for i in np.flatnonzero(hostm):
            ma, mi, go, ge = scores[i]
            out[i] = oracle.align_semi_global(seqs[ia[i]], seqs[ib[i]], ma,
                                              -abs(mi), go, ge)
        delta = np.abs(la - lb)
        if ed_hint is not None:
            h = np.asarray(ed_hint, dtype=np.int64)
            w = np.where(h >= 0, 2 * (delta + 2 * h) + 64, 2 * delta + 256)
        else:
            w = 2 * delta + 256
        band_arr = np.maximum(
            256, 1 << np.ceil(np.log2(np.maximum(w, 64))).astype(np.int64))
        sc = np.zeros((n_pairs, 4), dtype=np.int32)
        for i, (ma, mi, go, ge) in enumerate(scores):
            sc[i] = (ma, -abs(mi), go, ge)
        todo = np.flatnonzero(~hostm)
        bands = band_arr.copy()
        lmax = np.maximum(la, lb)
        nm = la + lb
        while todo.size:
            # every chunk of the round is launched, then the chunks are
            # collected in launch order: the host slices one while the
            # card runs the ones after it
            launched = []
            Lb_arr = _pool_widths(lmax[todo])
            keys = sorted(set(zip(Lb_arr.tolist(), bands[todo].tolist())))
            for Lb, Wp in keys:
                idxs = todo[(Lb_arr == Lb) & (bands[todo] == Wp)]
                cap = int(ALIGN_SCRATCH_BYTES // (Lb * Wp))
                bchunk = max(1, min(ALIGN_BATCH,
                                    1 << max(cap.bit_length() - 1, 0)))
                pool = self._get_pool(Lb)
                ia_all = self._pool_rows_for(pool, Lb, ia[idxs])
                ib_all = self._pool_rows_for(pool, Lb, ib[idxs])
                respell_all = ~(pool.exact[ia_all] & pool.exact[ib_all])
                mat, plen, _peq = pool.tensors()
                for s in range(0, len(idxs), bchunk):
                    chunk = idxs[s: s + bchunk]
                    csc = sc[chunk]
                    vecs = (ia_all[s: s + bchunk], ib_all[s: s + bchunk],
                            csc[:, 0], csc[:, 1], csc[:, 2], csc[:, 3])
                    batch = self.sharder.launch(
                        sg_align_pool, (mat, plen), vecs, to_host=fetch,
                        Wp=Wp, nm_max=int(nm[chunk].max()))
                    self.counters["upload_bytes"] += _nbytes(vecs)
                    launched.append((chunk, respell_all[s: s + bchunk],
                                     batch, Lb, Wp))
            next_round = []
            for chunk, respell, batch, Lb, Wp in launched:
                (_best, _ei, _ej, _fi, _fj, ov, alen, nmat, nmis, a1,
                 a2) = self._collect(batch, "align_wait_seconds")
                t_decode = time.perf_counter()
                # one string a row array, decoded from its buffer; a pair's
                # rows are slices of it
                w = a1.shape[1]
                s1 = codecs.latin_1_decode(np.ascontiguousarray(a1))[0]
                s2 = codecs.latin_1_decode(np.ascontiguousarray(a2))[0]
                card = host = 0
                for pos, (i, o, r, A, ma, mi) in enumerate(zip(
                        chunk.tolist(), ov.tolist(), respell.tolist(),
                        alen.tolist(), nmat.tolist(), nmis.tolist())):
                    if o:
                        self.counters["align_overflows"] += 1
                        bands[i] = Wp * 2
                        if bands[i] > 4 * Lb + 512:
                            raise BandOverflow((seqs[ia[i]][:30],
                                                seqs[ib[i]][:30], Wp))
                        next_round.append(i)
                        continue
                    x = pos * w
                    if r:
                        out[i] = respell_rows(s1[x:x + A], s2[x:x + A],
                                              seqs[ia[i]], seqs[ib[i]])
                        host += 1
                    else:
                        out[i] = (s1[x:x + A], s2[x:x + A],
                                  (ma, mi, A - ma - mi))
                        card += 1
                self.counters["align_card_rows"] += card
                self.counters["align_host_rows"] += host
                self.counters["align_decode_seconds"] += (
                    time.perf_counter() - t_decode)
            todo = np.asarray(next_round, dtype=np.int64)
        return out
