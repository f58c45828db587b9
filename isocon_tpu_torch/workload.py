"""Deterministic synthetic amplicon reads: the 10k-read workload and the
long-read workload (every read longer than 16,384 bases).

A copy of the generator in ``scripts/bench_10k.py`` (that script parses
``sys.argv`` when imported, so it is not imported here): gene families of
26 isoforms each (13 exon combinations x 2 SNV haplotypes) and reads
drawn round-robin from all isoforms with 1% noise, all from
``random.Random(seed)``.  Family 0 has the exon lengths ``EXON_LENS``
(isoforms of about 1.2-1.65 kb); each further family draws six exon
lengths in 120-449 bases.  The first N reads of a larger file are the
N-read file.  The 10k-read workload is one family; the nontargeted one
(``--nontargeted``: an amplicon run over several genes) is
``write_reads(path, 10000, families=4)``, 104 isoforms, the same as
``ISOCON_BENCH_FAMILIES=4 scripts/bench_10k.py 10000``.

The long-read workload (``write_long_reads``) is one family of 8 isoforms
(4 exon combinations x 2 SNV haplotypes) of 16.5-20 kb, as long-range PCR
or full-length viral amplicons give, with HiFi-like 0.2% noise: every pair
of reads lands in the 32,768-wide bucket.
"""
from __future__ import annotations

import random
from typing import List

COMBOS = [
    (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4), (0, 1, 2, 4, 5),
    (0, 2, 3, 4, 5), (0, 1, 3, 4, 5), (0, 1, 2, 3, 5),
    (0, 2, 4, 5), (0, 1, 3, 5), (0, 2, 3, 4), (0, 1, 2, 4),
    (0, 3, 4, 5), (0, 1, 4, 5), (0, 2, 3, 5),
]
EXON_LENS = (350, 200, 300, 250, 400, 150)


def make_family(rng: random.Random, exon_lens) -> List[str]:
    """26 isoforms: 13 exon-combination variants x 2 SNV haplotypes."""
    exons = ["".join(rng.choice("ACGT") for _ in range(ln))
             for ln in exon_lens]
    isoforms = []
    for combo in COMBOS:
        seq = "".join(exons[e] for e in combo)
        isoforms.append(seq)
        bl = list(seq)
        for frac in (0.2, 0.5, 0.8):
            p = int(len(bl) * frac)
            bl[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bl[p]]
        isoforms.append("".join(bl))
    return isoforms


def make_isoforms(rng: random.Random, families: int = 1) -> List[str]:
    """Family 0 with ``EXON_LENS``, then ``families - 1`` families of six
    exon lengths drawn in 120-449 bases."""
    isoforms = make_family(rng, EXON_LENS)
    for _f in range(1, families):
        lens = tuple(int(rng.randrange(120, 450)) for _ in range(6))
        isoforms.extend(make_family(rng, lens))
    return isoforms


def noisy_copy(rng: random.Random, s: str, error_rate: float = 0.01) -> str:
    out = []
    for ch in s:
        r = rng.random()
        if r < error_rate * 0.4:
            out.append(rng.choice([c for c in "ACGT" if c != ch]))
        elif r < error_rate * 0.7:
            out.append(ch)
            out.append(rng.choice("ACGT"))
        elif r < error_rate:
            pass
        else:
            out.append(ch)
    return "".join(out)


def write_reads(path: str, n_reads: int, seed: int = 123,
                families: int = 1) -> List[str]:
    """Write ``n_reads`` noisy reads of ``families`` gene families as
    fasta; returns the isoforms."""
    rng = random.Random(seed)
    isoforms = make_isoforms(rng, families)
    with open(path, "w") as fh:
        for i in range(n_reads):
            iso = isoforms[i % len(isoforms)]
            fh.write(">read_%d\n%s\n" % (i, noisy_copy(rng, iso)))
    return isoforms


# the long-read family: 5 exons, 20,000 bases with all of them; dropping
# exon 1 and / or exon 3 leaves 18,400, 18,100 and 16,500 bases
LONG_EXON_LENS = (6000, 1600, 5000, 1900, 5500)
LONG_COMBOS = [(0, 1, 2, 3, 4), (0, 2, 3, 4), (0, 1, 2, 4), (0, 2, 4)]
LONG_ERROR_RATE = 0.002


def make_long_isoforms(rng: random.Random) -> List[str]:
    """8 isoforms of 16,500-20,000 bases: 4 exon combinations x 2 SNV
    haplotypes (three substitutions)."""
    exons = ["".join(rng.choice("ACGT") for _ in range(ln))
             for ln in LONG_EXON_LENS]
    isoforms = []
    for combo in LONG_COMBOS:
        seq = "".join(exons[e] for e in combo)
        isoforms.append(seq)
        bl = list(seq)
        for frac in (0.2, 0.5, 0.8):
            p = int(len(bl) * frac)
            bl[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bl[p]]
        isoforms.append("".join(bl))
    return isoforms


def write_long_reads(path: str, n_reads: int, seed: int = 321) -> List[str]:
    """Write ``n_reads`` noisy long reads as fasta, drawn round-robin from
    the 8 long isoforms; returns the isoforms."""
    rng = random.Random(seed)
    isoforms = make_long_isoforms(rng)
    with open(path, "w") as fh:
        for i in range(n_reads):
            iso = isoforms[i % len(isoforms)]
            fh.write(">read_%d\n%s\n" % (
                i, noisy_copy(rng, iso, LONG_ERROR_RATE)))
    return isoforms
