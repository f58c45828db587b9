"""Minimal BAM reader for CCS ingestion (pysam/htslib replacement).

Parses just what the pipeline needs from a PacBio ccs.bam
(``ccs_info.py:317-337``): query name, sequence, base qualities and the
``np`` (number of passes) tag.  BGZF is a series of standard gzip members,
which ``gzip`` decodes natively; records are parsed per the SAM/BAM spec.
"""
from __future__ import annotations

import gzip
import re
import struct
from typing import Dict, Iterator, Optional, Tuple

from .ccs import CCS

_SEQ_NT = "=ACMGRSVTWYHKDBN"


class BamRecord:
    __slots__ = ("name", "flag", "seq", "qual", "tags")

    def __init__(self, name, flag, seq, qual, tags):
        self.name = name
        self.flag = flag
        self.seq = seq
        self.qual = qual  # list of ints, or None
        self.tags = tags


def _read_exact(fh, n: int) -> bytes:
    data = fh.read(n)
    if len(data) != n:
        raise EOFError("truncated BAM stream")
    return data


def _parse_tags(buf: bytes) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    i = 0
    while i + 3 <= len(buf):
        tag = buf[i : i + 2].decode("ascii")
        typ = chr(buf[i + 2])
        i += 3
        if typ == "A":
            tags[tag] = chr(buf[i]); i += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, i)[0]; i += 1
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", buf, i)[0]; i += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, i)[0]; i += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, i)[0]; i += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, i)[0]; i += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, i)[0]; i += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, i)[0]; i += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", i)
            tags[tag] = buf[i:end].decode("ascii")
            i = end + 1
        elif typ == "B":
            sub = chr(buf[i]); i += 1
            count = struct.unpack_from("<I", buf, i)[0]; i += 4
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            size = struct.calcsize(fmt)
            tags[tag] = list(struct.unpack_from("<%d%s" % (count, fmt), buf, i))
            i += count * size
        else:
            raise ValueError("unknown BAM tag type %r" % typ)
    return tags


def read_bam(path: str) -> Iterator[BamRecord]:
    with gzip.open(path, "rb") as fh:
        magic = _read_exact(fh, 4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file: bad magic %r" % magic)
        (l_text,) = struct.unpack("<i", _read_exact(fh, 4))
        _read_exact(fh, l_text)  # header text
        (n_ref,) = struct.unpack("<i", _read_exact(fh, 4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(fh, 4))
            _read_exact(fh, l_name + 4)  # name + l_ref
        while True:
            head = fh.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            buf = _read_exact(fh, block_size)
            (_ref_id, _pos, l_read_name, _mapq, _bin, n_cigar, flag, l_seq,
             _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
            off = 32
            name = buf[off : off + l_read_name - 1].decode("ascii")
            off += l_read_name
            off += 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            seq_packed = buf[off : off + nbytes]
            off += nbytes
            seq = "".join(
                _SEQ_NT[(seq_packed[k // 2] >> (4 if k % 2 == 0 else 0)) & 0xF]
                for k in range(l_seq)
            )
            qual_raw = buf[off : off + l_seq]
            off += l_seq
            qual: Optional[list] = (
                None if (l_seq and qual_raw[0] == 0xFF) else list(qual_raw)
            )
            tags = _parse_tags(buf[off:])
            yield BamRecord(name, flag, seq, qual, tags)


def read_ccs_bam(path: str) -> Dict[str, CCS]:
    """{movie/zmw id: CCS} keyed like ``ccs_info.get_ccs``
    (``ccs_info.py:317-337``): read names matching ``.+/ccs`` are keyed by
    the name minus the trailing ``/ccs``."""
    out: Dict[str, CCS] = {}
    pattern = re.compile(r".+/ccs")
    for rec in read_bam(path):
        m = pattern.search(rec.name)
        if not m:
            continue
        read_id = m.group(0)[:-4]
        assert rec.qual is not None and len(rec.seq) == len(rec.qual)
        out[read_id] = CCS(read_id, rec.seq, rec.qual, rec.tags.get("np"))
    return out


# ---------------------------------------------------------------------------
# writer (used by tests and the ccs_bam_to_fastq tool round-trip)
# ---------------------------------------------------------------------------

_NT_CODE = {c: i for i, c in enumerate(_SEQ_NT)}


def write_bam(path: str, records, header_text: str = "@HD\tVN:1.6\n") -> None:
    """Write unmapped records (name, seq, qual list, tags dict) as BAM."""
    body = bytearray()
    body += b"BAM\x01"
    ht = header_text.encode()
    body += struct.pack("<i", len(ht)) + ht
    body += struct.pack("<i", 0)  # n_ref
    for name, seq, qual, tags in records:
        nb = name.encode() + b"\x00"
        packed = bytearray()
        for k in range(0, len(seq), 2):
            hi = _NT_CODE.get(seq[k], 15) << 4
            lo = _NT_CODE.get(seq[k + 1], 15) if k + 1 < len(seq) else 0
            packed.append(hi | lo)
        tagbuf = bytearray()
        for tag, val in tags.items():
            if isinstance(val, int):
                tagbuf += tag.encode() + b"i" + struct.pack("<i", val)
            elif isinstance(val, float):
                tagbuf += tag.encode() + b"f" + struct.pack("<f", val)
            else:
                tagbuf += tag.encode() + b"Z" + str(val).encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHiiii", -1, -1, len(nb), 255, 0, 0, 4, len(seq), -1, -1, 0
        )
        rec += nb + bytes(packed) + bytes(bytearray(qual)) + bytes(tagbuf)
        body += struct.pack("<i", len(rec)) + rec
    with gzip.open(path, "wb") as fh:
        fh.write(bytes(body))
