"""Seeded amplicon reads for the benchmark's jobs.

Frozen copy of the read model of ``isocon_tpu_torch/workload.py`` (commit
2110776): a gene family is a set of exons, its isoforms are exon
combinations, each taken twice (as drawn, and with three SNVs at 20%, 50%
and 80% of its length: a second haplotype), and reads are drawn
round-robin over the isoforms, each a noisy copy with substitutions,
insertions (a random base after the true one) and deletions in the
ratio 0.4 : 0.3 : 0.3.  Two things differ from the original, both for
speed: the random numbers come from numpy's generator (so the bases
differ from the original's for the same seed; the sizes and the model do
not), and the noise is applied to all reads of a job at once.  The
original's Python loop per base spends 0.34 s on 2,000 reads of about
1.3 kb and 1.3 s on 500 reads of 16.5-20 kb on one core; a job's reads
are made between jobs, inside the measured window, where this takes
about a third and a fifth of that.

Everything of one configuration comes from its JSON file
(``configs/<name>.json``): ``exon_lens``, ``combos``, ``snv_fracs``,
``error_rate``, ``error_mix`` and ``reads_per_job``.  Job k of a run
with seed s draws from ``numpy.random.default_rng([s, k])``: every job
is a new family, and every seed gives jobs of the same sizes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# the SNV of the second haplotype: A->C, C->G, G->T, T->A
SNV_NEXT = (1, 2, 3, 0)


def job_rng(seed: int, job: int) -> np.random.Generator:
    """The generator of job ``job`` of a run with ``seed`` (any integer;
    job -1 is the warm-up, which no window uses)."""
    return np.random.default_rng([seed % 2 ** 64, job % 2 ** 64])


def make_isoforms(rng: np.random.Generator, exon_lens: Sequence[int],
                  combos: Sequence[Sequence[int]],
                  snv_fracs: Sequence[float]) -> List[np.ndarray]:
    """Base codes (0-3) of each isoform: per combination, the exons joined
    and the same with one SNV at each of ``snv_fracs`` of its length."""
    exons = [rng.integers(0, 4, size=int(n), dtype=np.uint8)
             for n in exon_lens]
    snv = np.asarray(SNV_NEXT, dtype=np.uint8)
    isoforms = []
    for combo in combos:
        seq = np.concatenate([exons[e] for e in combo])
        isoforms.append(seq)
        alt = seq.copy()
        for frac in snv_fracs:
            p = int(len(alt) * frac)
            alt[p] = snv[alt[p]]
        isoforms.append(alt)
    return isoforms


def noisy_reads(rng: np.random.Generator, isoforms: List[np.ndarray],
                n_reads: int, error_rate: float,
                mix: Tuple[float, float, float]) -> List[np.ndarray]:
    """``n_reads`` noisy copies drawn round-robin over ``isoforms``: each
    base is substituted (another base), followed by an inserted base, or
    deleted, with the shares ``mix`` of ``error_rate``."""
    src = [isoforms[i % len(isoforms)] for i in range(n_reads)]
    lens = np.fromiter((len(s) for s in src), dtype=np.int64, count=n_reads)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.concatenate(src)
    r = rng.random(flat.size)
    sub_hi = error_rate * mix[0]
    ins_hi = sub_hi + error_rate * mix[1]
    sub = np.flatnonzero(r < sub_hi)
    ins = np.flatnonzero((r >= sub_hi) & (r < ins_hi))
    dele = np.flatnonzero((r >= ins_hi) & (r < error_rate))
    flat[sub] = (flat[sub] + rng.integers(1, 4, size=sub.size,
                                          dtype=np.uint8)) % 4
    # a base after each insertion site, then the deleted bases removed
    # (their positions moved on by the insertions before them)
    out = np.insert(flat, ins + 1,
                    rng.integers(0, 4, size=ins.size, dtype=np.uint8))
    out = np.delete(out, dele + np.searchsorted(ins, dele))
    read_of = lambda pos: np.searchsorted(starts, pos, side="right") - 1
    out_lens = (lens + np.bincount(read_of(ins), minlength=n_reads)
                - np.bincount(read_of(dele), minlength=n_reads))
    return np.split(out, np.cumsum(out_lens)[:-1])


def decode(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode("ascii")


def make_job(config: dict, seed: int, job: int,
             n_reads: int | None = None) -> Tuple[List[str], List[str]]:
    """(isoforms, reads) of job ``job``: ``config``'s family with
    ``n_reads`` reads (default ``reads_per_job``)."""
    rng = job_rng(seed, job)
    isoforms = make_isoforms(rng, config["exon_lens"], config["combos"],
                             config["snv_fracs"])
    mix = tuple(config["error_mix"][k]
                for k in ("substitution", "insertion", "deletion"))
    reads = noisy_reads(rng, isoforms, n_reads or config["reads_per_job"],
                        config["error_rate"], mix)
    return [decode(s) for s in isoforms], [decode(s) for s in reads]


def write_fasta(path: str, reads: List[str]) -> None:
    with open(path, "w") as fh:
        fh.write("".join(">read_%d\n%s\n" % (i, s)
                         for i, s in enumerate(reads)))
