"""Dense (numpy) multi-alignment matrices, and a round's correction.

The production path of ``correct_strings``: the same star MAM as
``mam.py`` (the per-string reference implementation, kept as the oracle)
built as flat uint8 byte matrices instead of per-character Python loops
(SURVEY.md sec 7 step 5; reference ``functions.py:526-767``).  A round's
MAMs are then voted on and corrected all at once by
``ops/consensus.py::consensus_round`` (the PFM and the ceil(0.5 *
minority) type-normalized correction of ``correction_module.py:260-446``),
on the engine's card, or by its plain version on the CPU.

Layout: the MAM of a partition of K rows against center m of length L is
a [K, W] uint8 byte matrix.  Columns interleave the 2L+1 reference slots
(even = insertion slots, odd = bases of m); insertion slots expand to the
width of their longest unique insertion (+2 flanking dashes) exactly as
``create_multialignment_format`` does, with the same ``_best_solution``
placement rules for the (few) non-trivial insertion strings.

Exactness: integer PFM counts are identical; correction ratios use the
same float64 divisions; the cut takes every mismatch whose ratio is at
most the ceil(n / 2)-th smallest, which is the reference's stable sort
extended through ties, decision for decision.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.consensus import consensus_round, fetch
from ..parallel import sharding
from .mam import _best_solution

_DASH = np.uint8(ord("-"))


def _row_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin1"), dtype=np.uint8)


def build_dense_mam(
    m: str, partition: Dict[str, Tuple[int, str, str, int]]
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Dense star MAM.

    Returns (row order = sorted members, matrix [K, W] uint8,
    degrees [K] int64).  Row strings reproduce ``mam.
    create_multialignment_matrix`` exactly (property-tested).
    """
    L = len(m)
    accs = sorted(partition)
    K = len(accs)
    odd = np.full((K, L), _DASH, dtype=np.uint8)
    # insertions per even slot: slot -> {ins_string: [row indices]}
    slot_ins: Dict[int, Dict[str, List[int]]] = {}

    for k, acc in enumerate(accs):
        _ed, m_aln, s_aln, _deg = partition[acc]
        ma = _row_bytes(m_aln)
        sa = _row_bytes(s_aln)
        tmask = ma != _DASH
        tcols = np.flatnonzero(tmask)
        assert len(tcols) == L, (len(tcols), L)
        odd[k] = sa[tcols]
        gaps = np.flatnonzero(~tmask)
        if gaps.size:
            # insertion at alignment column g belongs to the even slot
            # equal to the number of target chars before g
            nd = np.cumsum(tmask)
            slots = nd[gaps]
            # group consecutive gap columns with equal slot into strings
            brk = np.flatnonzero(
                (np.diff(gaps) != 1) | (np.diff(slots) != 0)
            )
            starts = np.concatenate(([0], brk + 1))
            ends = np.concatenate((brk + 1, [gaps.size]))
            for a, b in zip(starts, ends):
                ins = s_aln[gaps[a] : gaps[a] + (b - a)]
                slot = int(slots[a])
                slot_ins.setdefault(slot, {}).setdefault(ins, []).append(k)

    # per even slot: width and (for expanded slots) placed solutions
    widths = np.ones(2 * L + 1, dtype=np.int64)
    expanded: Dict[int, np.ndarray] = {}
    for slot, by_ins in slot_ins.items():
        max_len = max(len(x) for x in by_ins)
        if max_len == 1:
            continue  # width-1 slot; cells are the raw single chars
        max_ins = sorted(x for x in by_ins if len(x) == max_len)[0]
        mx = "-" + max_ins + "-"
        w = len(mx)
        widths[2 * slot] = w
        block = np.full((K, w), _DASH, dtype=np.uint8)
        for ins, rows in by_ins.items():
            sol = _row_bytes("".join(_best_solution(mx, ins)))
            block[rows] = sol
        expanded[slot] = block

    offsets = np.concatenate(([0], np.cumsum(widths)))
    W = int(offsets[-1])
    out = np.full((K, W), _DASH, dtype=np.uint8)
    out[:, offsets[1 : 2 * L : 2]] = odd     # odd slots, width 1
    for slot, by_ins in slot_ins.items():
        off = int(offsets[2 * slot])
        if slot in expanded:
            out[:, off : off + expanded[slot].shape[1]] = expanded[slot]
        else:
            for ins, rows in by_ins.items():
                out[rows, off] = ord(ins)
    degs = np.array([partition[a][3] for a in accs], dtype=np.int64)
    return accs, out, degs


def check_round_trip(accs: List[str], mat: np.ndarray) -> None:
    """Each row of the MAM, '-' bytes removed, is its own member
    (``correction_module.py:273-275``): each row's count of other bytes is
    its member's length, and all of them in order are the members joined."""
    keep = mat != _DASH
    lens = np.fromiter(map(len, accs), dtype=np.int64, count=len(accs))
    assert np.array_equal(keep.sum(axis=1), lens)
    assert mat[keep].tobytes() == "".join(accs).encode("latin1")


def pack_round(
    parts: Sequence[Tuple[List[str], np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A round's dense partitions in ``ops/consensus.py``'s layout.

    ``parts``: each partition's ``build_dense_mam`` (members, MAM,
    degrees).  Returns (mat uint8 [N], part int64 [P, 5], deg int64, rows
    int64 [2, R]): the rows to correct are the members of degree 1 (a
    converged member is never corrected, ``correction_module.py:316-317``).
    """
    P = len(parts)
    table = np.zeros((P, 5), dtype=np.int64)
    fix_rows, fix_parts = [], []
    base = row0 = col0 = 0
    for p, (_accs, mat, degs) in enumerate(parts):
        K, W = mat.shape
        table[p] = (base, K, W, row0, col0)
        fix = np.flatnonzero(degs <= 1)
        fix_rows.append(fix + row0)
        fix_parts.append(np.full(fix.size, p, dtype=np.int64))
        base += K * W
        row0 += K
        col0 += W
    flat = np.concatenate([mat.ravel() for _a, mat, _d in parts])
    deg = np.concatenate([d for _a, _m, d in parts]).astype(np.int64)
    rows = np.stack([np.concatenate(fix_rows), np.concatenate(fix_parts)])
    return flat, table, deg, rows


def correct_round(
    parts: Sequence[Tuple[List[str], np.ndarray, np.ndarray]],
    device: torch.device,
    counters: Optional[dict] = None,
) -> List[Dict[str, str]]:
    """Vote and correct a round's dense partitions at once.

    ``parts``: each partition's ``build_dense_mam`` (members, MAM,
    degrees).  ``pack_round``'s MAM buffer goes to ``device`` in one copy,
    and its table, degrees and rows in one int64 buffer; the corrected rows
    come back in one copy and one latin-1 decode.  Returns, for each
    partition, {member: corrected string} of its corrected members.
    ``counters``: the engine's, whose ``upload_bytes`` counts both buffers
    and ``consensus_rows_card`` the rows voted on."""
    if not parts:
        return []
    flat, table, deg, rows = pack_round(parts)
    P, K = table.shape[0], deg.size
    meta = np.concatenate([table.ravel(), deg, rows.ravel()])
    mat_d = sharding.upload(flat, device)
    meta_d = sharding.upload(meta, device)
    if counters is not None:
        counters["upload_bytes"] += flat.nbytes + meta.nbytes
        counters["consensus_rows_card"] += K
    outs = consensus_round(
        mat_d, meta_d[:5 * P].view(P, 5), meta_d[5 * P:5 * P + K],
        meta_d[5 * P + K:].view(2, -1), cols=int(table[:, 2].sum()),
        width=int(table[:, 2].max()))
    lens, nmis, fixed = fetch(outs)
    A = fixed.shape[1]
    text = fixed.tobytes().decode("latin-1")
    corrected: List[Dict[str, str]] = [{} for _ in parts]
    for i in np.flatnonzero(nmis > 0).tolist():
        r, p = int(rows[0, i]), int(rows[1, i])
        member = parts[p][0][r - int(table[p, 3])]
        corrected[p][member] = text[i * A:i * A + int(lens[i])]
    return corrected
