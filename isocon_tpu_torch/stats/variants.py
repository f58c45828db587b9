"""Variant extraction and per-read support/probability computation.

Re-implements the ``functions.py`` statistical helpers:

* ``get_variant_coordinates`` (``functions.py:89-146``): positions where the
  candidate differs from its test reference, with homopolymer invariant
  lengths u_v.
* ``get_support`` (``:149-201``): which reads exactly reproduce the
  candidate's variants in a +/-1 window.
* ``get_read_errors`` (``:204-215``).
* ``get_empirical_error_probabilities`` (``:435-466``).
* CCS/fastq quality-based probabilities (``:240-432``).
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

_DASH = np.uint8(ord("-"))


def get_variant_coordinates(
    t_seq: str, c_seq: str, aln_t: str, aln_c: str, variants
):
    """``functions.py:89-146`` -- returns (variant_coords_t,
    variant_coords_c, alignment_c_to_t, alignment_t_to_c)."""
    variant_coords_t = {}
    variant_coords_c = {}
    alignment_c_to_t = {}
    alignment_t_to_c = {}
    nd_t = _nondash_cumsum(aln_t)
    nd_c = _nondash_cumsum(aln_c)
    for (i, p_t, p_c) in variants:
        t_pos = int(nd_t[i]) - 1
        c_pos = int(nd_c[i]) - 1

        if p_c == "-":  # deletion in candidate
            v = t_seq[t_pos]
            m_f = re.match("[%s]+" % v, t_seq[t_pos + 1 :])
            m_r = re.match("[%s]+" % v, t_seq[t_pos::-1])
            if m_f and m_r:
                u_v = len(m_f.group()) + len(m_r.group())
            elif m_f:
                u_v = len(m_f.group())
            elif m_r:
                u_v = len(m_r.group())
            else:
                u_v = 1
            variant_coords_t[t_pos] = ("D", "-", u_v)
            variant_coords_c[c_pos + 1] = ("D", "-", u_v)
            alignment_c_to_t[t_pos] = aln_c[max(0, i - 1) : i + u_v + 1]
            alignment_t_to_c[c_pos + 1] = aln_t[max(0, i - 1) : i + u_v + 1]

        elif p_t == "-":  # insertion in candidate
            v = c_seq[c_pos]
            m_f = re.match("[%s]+" % v, t_seq[t_pos + 1 :])
            m_r = re.match("[%s]+" % v, t_seq[t_pos::-1])
            if m_f and m_r:
                u_v = len(m_f.group()) + len(m_r.group()) + 1
            elif m_f:
                u_v = len(m_f.group()) + 1
            elif m_r:
                u_v = len(m_r.group()) + 1
            else:
                u_v = 1
            variant_coords_t[t_pos + 1] = ("I", p_c, u_v)
            variant_coords_c[c_pos] = ("I", p_c, u_v)
            alignment_c_to_t[t_pos + 1] = aln_c[max(0, i - 1) : i + u_v + 1]
            alignment_t_to_c[c_pos] = aln_t[max(0, i - 1) : i + u_v + 1]

        else:  # substitution
            variant_coords_t[t_pos] = ("S", p_c, 1)
            variant_coords_c[c_pos] = ("S", p_c, 1)
            alignment_c_to_t[t_pos] = aln_c[max(0, i - 1) : i + 2]
            alignment_t_to_c[c_pos] = aln_t[max(0, i - 1) : i + 2]

    return variant_coords_t, variant_coords_c, alignment_c_to_t, alignment_t_to_c


def _nondash_cumsum(aln: str) -> np.ndarray:
    """#non-dash chars in aln[:k+1], per column k."""
    arr = np.frombuffer(aln.encode("latin1"), dtype=np.uint8)
    return np.cumsum(arr != _DASH)


def get_support(
    store, read_alignments_to_c, rows_c, variant_coords_c,
    read_alignments_to_t, rows_t, variant_coords_t, alignment_c_to_t,
) -> List[str]:
    """Reads exactly matching the candidate over every variant window
    (``functions.py:149-201``): a read of c where its window equals c's
    window of its own alignment, a read of t where its window equals the
    c-to-t snippet.  ``rows_*``: the reads' rows in ``store``, in the
    dicts' order."""
    ok_c = _supporting(store, rows_c, variant_coords_c)
    ok_t = _supporting(store, rows_t, variant_coords_t, alignment_c_to_t)
    return ([acc for acc, ok in zip(read_alignments_to_c, ok_c) if ok]
            + [acc for acc, ok in zip(read_alignments_to_t, ok_t) if ok])


def _supporting(store, rows, variant_coords, snippets=None) -> List[bool]:
    """For each row, whether every variant's window matches: the read row's
    slice ``[max(0, p - 1), p + u_v + 1)`` (``[max(0, p - 2), p + u_v)``
    for an ``I`` against a snippet), p the variant's column, equals the
    reference row's slice there, or ``snippets[i]``.  One variant at a
    time over the rows still matching; a slice past the row's end is
    shorter, as Python slices are."""
    alive = np.arange(len(rows))
    for i, (v_type, _v_nucl, u_v) in variant_coords.items():
        if alive.size == 0:
            break
        r = rows[alive]
        p = store.columns(r, i)
        if snippets is not None and v_type == "I":
            lo, hi = np.maximum(p - 2, 0), p + u_v
        else:
            lo, hi = np.maximum(p - 1, 0), p + u_v + 1
        width = np.minimum(hi, store.length[r]) - lo
        if snippets is None:
            w = int(width.max())
        else:
            want = np.frombuffer(snippets[i].encode("latin1"), np.uint8)
            w = want.size
        k = np.arange(w)
        inside = k < width[:, None]
        at = store.start[r][:, None] + lo[:, None] + np.where(inside, k, 0)
        got = store.read[at]
        if snippets is None:
            match = ((got == store.ref[at]) | ~inside).all(axis=1)
        else:
            match = (width == w) & ((got == want) | ~inside).all(axis=1)
        alive = alive[match]
    ok = np.zeros(len(rows), dtype=bool)
    ok[alive] = True
    return ok.tolist()


def get_read_errors(store, read_alignments_to_c, rows_c,
                    read_alignments_to_t, rows_t):
    """``functions.py:204-215``: each read's (insertions, deletions,
    substitutions) from ``store``, t's reads first (the reference's
    dict-update order)."""
    keys = list(read_alignments_to_t) + list(read_alignments_to_c)
    errors = store.errors[np.concatenate([rows_t, rows_c])].tolist()
    return dict(zip(keys, map(tuple, errors)))


def get_empirical_error_probabilities(
    segment_length: int, reads, errors: np.ndarray, variant_coords_t
):
    """``functions.py:435-466`` over all reads at once: ``errors`` holds
    each read's (insertions, deletions, substitutions), a row a read of
    ``reads``.  The variants multiply in in dict order, so each read's
    float64 products are the scalar loop's, operation for operation."""
    delta_size = float(len(variant_coords_t))
    assert delta_size > 0.0
    length = float(segment_length)
    errors = np.asarray(errors, dtype=np.float64).reshape(-1, 3)
    p_S = (np.maximum(errors[:, 2], delta_size) / length) / 3.0
    p_I = (np.maximum(errors[:, 0], delta_size) / length) / 4.0
    p_D = np.maximum(errors[:, 1], delta_size) / length
    prob = np.ones(len(errors))
    for v_type, _v_nucl, u_v in variant_coords_t.values():
        if v_type == "S":
            prob *= p_S * u_v
        elif v_type == "I":
            prob *= np.minimum(0.5, p_I * u_v)
        elif v_type == "D":
            prob *= np.minimum(0.5, p_D * u_v)
    prob[prob >= 1.0] = 0.99999
    return dict(zip(reads, prob.tolist()))


def _error_ratios(errors):
    subs = float(max(1.0, sum(s for _i, _d, s in errors.values())))
    ins = float(max(1.0, sum(i for i, _d, _s in errors.values())))
    dele = float(max(1.0, sum(d for _i, d, _s in errors.values())))
    tot = subs + ins + dele
    return subs / tot, ins / tot, dele / tot


def _p_error_from_qual(q_qual, max_phred_q_trusted, v_type, u_v, ratios):
    subs_ratio, ins_ratio, del_ratio = ratios
    q_mapped = (q_qual - 3) * (max_phred_q_trusted - 3.0) / 90.0 + 3
    p = 10 ** (-q_mapped / 10.0)
    if u_v > 1:
        return p
    if v_type == "S":
        return p * subs_ratio / 3.0
    if v_type == "I":
        return p * ins_ratio / 4.0
    return p * del_ratio  # D


def get_read_ccs_probabilities_c(
    store, read_alignments_to_c, rows_c, variant_coords_c, alignment_t_to_c,
    ccs_dict, errors, max_phred_q_trusted,
):
    """``functions.py:240-331``."""
    ratios = _error_ratios(errors)
    assert len(variant_coords_c) > 0
    probabilities = {}
    non_supportive = set()
    for (read_acc, (aln_c, aln_read, _st)), row in zip(
            read_alignments_to_c.items(), rows_c):
        cmap = store.coord_map(row)
        nd_read = _nondash_cumsum(aln_read)
        prob = 1.0
        for i, (v_type, v_nucl, u_v) in variant_coords_c.items():
            p = int(cmap[i])
            match_c = (
                aln_read[max(0, p - 1) : p + u_v + 1]
                == aln_c[max(0, p - 1) : p + u_v + 1]
            )
            snippet_t = alignment_t_to_c[i]
            if v_type == "D":
                match_t = aln_read[max(0, p - 2) : p + u_v] == snippet_t
            else:
                match_t = aln_read[max(0, p - 1) : p + u_v + 1] == snippet_t
            assert not (match_c and match_t)
            if match_c:
                read_coord = int(nd_read[p]) - 1
            elif match_t:
                if v_type == "I":
                    read_coord = int(nd_read[p])
                else:
                    read_coord = int(nd_read[p]) - 1
            else:
                non_supportive.add(read_acc)
                prob = -1
                break
            ccs_coord = ccs_dict[read_acc].read_aln_to_ccs_coord(aln_read, read_coord)
            q_qual = ccs_dict[read_acc].qual[ccs_coord]
            prob *= _p_error_from_qual(q_qual, max_phred_q_trusted, v_type,
                                       u_v, ratios)
        if prob >= 0:
            assert 0.0 < prob < 1.0
            probabilities[read_acc] = prob
    return probabilities, non_supportive


def get_read_ccs_probabilities_t(
    store, read_alignments_to_t, rows_t, variant_coords_t, alignment_c_to_t,
    ccs_dict, errors, max_phred_q_trusted,
):
    """``functions.py:334-432``."""
    ratios = _error_ratios(errors)
    assert len(variant_coords_t) > 0
    probabilities = {}
    non_supportive = set()
    for (read_acc, (aln_t, aln_read, _st)), row in zip(
            read_alignments_to_t.items(), rows_t):
        tmap = store.coord_map(row)
        nd_read = _nondash_cumsum(aln_read)
        prob = 1.0
        for i, (v_type, v_nucl, u_v) in variant_coords_t.items():
            p = int(tmap[i])
            match_t = (
                aln_read[max(0, p - 1) : p + u_v + 1]
                == aln_t[max(0, p - 1) : p + u_v + 1]
            )
            snippet_c = alignment_c_to_t[i]
            if v_type == "I":
                match_c = aln_read[max(0, p - 2) : p + u_v] == snippet_c
            else:
                match_c = aln_read[max(0, p - 1) : p + u_v + 1] == snippet_c
            assert not (match_c and match_t)
            if match_t:
                read_coord = int(nd_read[p]) - 1
            elif match_c:
                if v_type == "D":
                    read_coord = int(nd_read[p])
                elif v_type == "I":
                    read_coord = int(nd_read[p]) - 2
                else:
                    read_coord = int(nd_read[p]) - 1
            else:
                non_supportive.add(read_acc)
                prob = -1
                break
            ccs_coord = ccs_dict[read_acc].read_aln_to_ccs_coord(aln_read, read_coord)
            q_qual = ccs_dict[read_acc].qual[ccs_coord]
            prob *= _p_error_from_qual(q_qual, max_phred_q_trusted, v_type,
                                       u_v, ratios)
        if prob >= 0:
            assert 0.0 < prob < 1.0
            probabilities[read_acc] = prob
    return probabilities, non_supportive
