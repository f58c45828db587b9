"""Sequence encoding for the DP kernels.

Reads become padded int8 tensors: A=0, C=1, G=2, T=3, anything else
(N, IUPAC) gets a distinct code >=4 so it never matches anything, and PAD=7
never matches real bases.  The DP kernels only ever *compare* codes for
equality (unit-cost edit distance) or feed them through a match/mismatch
score, so any injective mapping works; this one keeps the alphabet in 3 bits.
"""
from __future__ import annotations

import numpy as np

PAD = 7

_LUT = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _LUT[ord(c)] = i
    _LUT[ord(c.lower())] = i
_LUT[ord("N")] = 5
_LUT[ord("n")] = 5

_REV = {0: "A", 1: "C", 2: "G", 3: "T", 5: "N"}


def encode_bytes(raw: np.ndarray) -> np.ndarray:
    """int8 codes of ASCII bytes (uint8)."""
    return _LUT[raw]


def encode_seq(seq: str) -> np.ndarray:
    """Encode a DNA string to int8 codes."""
    return encode_bytes(np.frombuffer(seq.encode("ascii"), dtype=np.uint8))


def decode_seq(codes) -> str:
    return "".join(_REV.get(int(c), "X") for c in codes)


def pad_batch(seqs, length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Encode and right-pad a list of strings to a common length.

    Returns (codes[B, L] int8, lengths[B] int32).
    """
    enc = [encode_seq(s) for s in seqs]
    lens = np.array([len(e) for e in enc], dtype=np.int32)
    L = int(length if length is not None else (max(lens) if len(lens) else 0))
    out = np.full((len(enc), L), PAD, dtype=np.int8)
    for i, e in enumerate(enc):
        out[i, : len(e)] = e
    return out, lens
