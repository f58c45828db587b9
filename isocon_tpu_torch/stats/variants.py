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
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..alnutils import read_errors_batch

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


def _coord_map(aln: str) -> np.ndarray:
    """seq position -> alignment column (vectorized: called per read per
    edge on ~2-4 kb alignment strings)."""
    arr = np.frombuffer(aln.encode("latin1"), dtype=np.uint8)
    return np.flatnonzero(arr != _DASH)


def get_support(
    read_alignments_to_c, variant_coords_c, read_alignments_to_t,
    variant_coords_t, alignment_c_to_t,
) -> List[str]:
    """Reads exactly matching the candidate over every variant window
    (``functions.py:149-201``)."""
    support_c = []
    for read_acc, (aln_c, aln_read, _st) in read_alignments_to_c.items():
        cmap = _coord_map(aln_c)
        ok = True
        for i, (v_type, v_nucl, u_v) in variant_coords_c.items():
            p = cmap[i]
            if aln_read[max(0, p - 1) : p + u_v + 1] != aln_c[max(0, p - 1) : p + u_v + 1]:
                ok = False
                break
        if ok:
            support_c.append(read_acc)

    support_from_t = []
    for read_acc, (aln_t, aln_read, _st) in read_alignments_to_t.items():
        tmap = _coord_map(aln_t)
        ok = True
        for i, (v_type, v_nucl, u_v) in variant_coords_t.items():
            p = tmap[i]
            snippet = alignment_c_to_t[i]
            if v_type == "I":
                match = aln_read[max(0, p - 2) : p + u_v] == snippet
            else:
                match = aln_read[max(0, p - 1) : p + u_v + 1] == snippet
            if not match:
                ok = False
                break
        if ok:
            support_from_t.append(read_acc)
    return support_c + support_from_t


def get_read_errors(read_alignments_to_c, read_alignments_to_t):
    """``functions.py:204-215``.  Batched: one padded-matrix pass per
    edge (c-assigned reads overwrite t-assigned ones, as the reference's
    dict-update order does)."""
    keys = list(read_alignments_to_t) + list(read_alignments_to_c)
    pairs = [(aln, read) for aln, read, _st in
             read_alignments_to_t.values()]
    pairs += [(aln, read) for aln, read, _st in
              read_alignments_to_c.values()]
    out = read_errors_batch(pairs)
    return dict(zip(keys, out))


def get_empirical_error_probabilities(
    segment_length: int, errors, variant_coords_t
):
    """``functions.py:435-466``."""
    probability = {}
    delta_size = float(len(variant_coords_t))
    assert delta_size > 0.0
    for read_acc, (insertions, deletions, substitutions) in errors.items():
        prob = 1.0
        p_S = (max(substitutions, delta_size) / float(segment_length)) / 3.0
        p_I = (max(insertions, delta_size) / float(segment_length)) / 4.0
        p_D = max(deletions, delta_size) / float(segment_length)
        for i, (v_type, v_nucl, u_v) in variant_coords_t.items():
            if v_type == "S":
                prob *= p_S * u_v
            elif v_type == "I":
                prob *= min(0.5, p_I * u_v)
            elif v_type == "D":
                prob *= min(0.5, p_D * u_v)
        if prob >= 1.0:
            prob = 0.99999
        probability[read_acc] = prob
    return probability


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
    read_alignments_to_c, variant_coords_c, alignment_t_to_c, ccs_dict,
    errors, max_phred_q_trusted,
):
    """``functions.py:240-331``."""
    ratios = _error_ratios(errors)
    assert len(variant_coords_c) > 0
    probabilities = {}
    non_supportive = set()
    for read_acc, (aln_c, aln_read, _st) in read_alignments_to_c.items():
        cmap = _coord_map(aln_c)
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
    read_alignments_to_t, variant_coords_t, alignment_c_to_t, ccs_dict,
    errors, max_phred_q_trusted,
):
    """``functions.py:334-432``."""
    ratios = _error_ratios(errors)
    assert len(variant_coords_t) > 0
    probabilities = {}
    non_supportive = set()
    for read_acc, (aln_t, aln_read, _st) in read_alignments_to_t.items():
        tmap = _coord_map(aln_t)
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
