"""The sketch's k-mer profiles built in one pass over the reads' bytes
(``ops/sketch.py::kmer_profiles``: K7 on the card, ``kmer_profiles_plain``
on the CPU) against the per-read ``kmer_profile`` of the port and of the
JAX package (``isocon_tpu/graph/sketch.py``) and the plain float64
reference (``graph/sketch_reference.py::profiles``), and
``approximate_matches`` on the CPU against the lists the per-read rows
give.  Tolerance: exact everywhere (the square roots compared bit for
bit).  K7 itself is held to the plain version on the card, in
``tests/test_torch_cuda.py``.
"""
import types

import numpy as np
import pytest
import torch

from isocon_tpu.graph import sketch as jax_sketch
from isocon_tpu_torch.graph import sketch as port_sketch
from isocon_tpu_torch.graph import sketch_reference
from isocon_tpu_torch.ops import sketch as ops_sketch
from portbench import spec

IUPAC = "ACGTRYKMSWBDHVN"


def _reads(seed, lens, alphabet="ACGT"):
    rs = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet.encode("ascii"), dtype=np.uint8)
    return [letters[rs.integers(0, letters.size, int(n))].tobytes().decode(
        "ascii") for n in lens]


def _isoform_lengths(seed, n):
    return np.random.default_rng(seed).integers(719, 1986, n)


CASES = {
    "length_0": lambda: _reads(0, [0, 0, 0]),
    "length_1": lambda: _reads(1, [1, 1, 1]),
    "length_7": lambda: _reads(7, [7, 7, 7]),
    "length_8": lambda: _reads(8, [8, 8, 8]),
    "length_9": lambda: _reads(9, [9, 9, 9]),
    "lengths_719_1985": lambda: _reads(10, _isoform_lengths(10, 40)),
    "length_16569": lambda: _reads(11, [16569, 16569]),
    "lowercase": lambda: _reads(12, _isoform_lengths(12, 20), "acgtACGT"),
    "n_letters": lambda: _reads(13, _isoform_lengths(13, 20), "ACGTNn"),
    "iupac": lambda: _reads(14, _isoform_lengths(14, 20),
                            IUPAC + IUPAC.lower()),
    "rows_1": lambda: _reads(15, [1166]),
    "rows_2": lambda: _reads(16, [719, 1985]),
    "rows_2001": lambda: _reads(17, _isoform_lengths(17, 2001)),
}


def _packed(seqs):
    """The reads' bytes back to back (uint8) and their offsets (int64
    [N + 1]), as ``approximate_matches`` sends them."""
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    raw = np.frombuffer(bytearray("".join(seqs), "ascii"), dtype=np.uint8)
    return torch.from_numpy(raw), torch.from_numpy(off)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_profiles_equal_the_per_read_profiles(case):
    seqs = CASES[case]()
    got = ops_sketch.kmer_profiles(*_packed(seqs))
    assert got.dtype == torch.float32
    assert got.shape == (len(seqs), ops_sketch.DIM)
    port = np.sqrt(np.stack([port_sketch.kmer_profile(s) for s in seqs]))
    jax = np.sqrt(np.stack([jax_sketch.kmer_profile(s) for s in seqs]))
    ref = np.sqrt(sketch_reference.profiles(seqs).numpy().astype(np.float32))
    for want in (port, jax, ref):
        assert np.array_equal(_bits(got.numpy()), _bits(want))
    short = np.array([len(s) < ops_sketch.KMER for s in seqs])
    assert not got.numpy()[short].any()
    assert (got.numpy()[~short].sum(axis=1) > 0).all()


def test_plain_profiles_read_offsets_into_a_larger_buffer():
    """Offsets need not start at 0 nor end at the buffer's end."""
    seqs = _reads(20, [5, 900, 12, 1500, 8, 700], "ACGTNnacgt")
    raw, off = _packed(seqs)
    got = ops_sketch.kmer_profiles(raw, off[2:5])
    want = np.sqrt(np.stack([port_sketch.kmer_profile(s)
                             for s in seqs[2:4]]))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", [2, 30, 257])
def test_approximate_matches_on_cpu_equal_the_per_read_lists(n):
    """The lists from the bytes' profiles equal those from the stacked
    per-read rows (the lists before the profiles moved to K7); the
    counters take the bytes sent and no card rows."""
    lens = _isoform_lengths(n, n) // 5
    lens[::7] = np.arange(lens[::7].size) % 9     # reads under 8 bases
    seqs = _reads(n, lens, "ACGTACGTNnRYacgt")
    roots = torch.from_numpy(np.sqrt(np.stack(
        [port_sketch.kmer_profile(s) for s in seqs])))
    k = min(port_sketch.TOPN, n - 1)
    want = ops_sketch.topn_indices(
        roots, torch.tensor([len(s) for s in seqs], dtype=torch.int32),
        k).tolist()
    counters = {"sketch_profile_seconds": 0.0, "upload_bytes": 0,
                "sketch_profile_card_rows": 0}
    assert port_sketch.approximate_matches(seqs, device="cpu",
                                           counters=counters) == want
    assert counters["upload_bytes"] == sum(lens) + 8 * (n + 1)
    assert counters["sketch_profile_card_rows"] == 0
    assert counters["sketch_profile_seconds"] > 0


def _run(*counters):
    return types.SimpleNamespace(jobs=[
        types.SimpleNamespace(counters_end=c) for c in counters])


@pytest.mark.parametrize("counters,want", [
    ([], None),
    ([{"sketch_rows": 10000}], None),             # an engine without K7
    ([{"sketch_rows": 0, "sketch_profile_card_rows": 0}], None),
    ([{"sketch_rows": 10000, "sketch_profile_card_rows": 10000},
      {"sketch_rows": 8000, "sketch_profile_card_rows": 8000}], 100.0),
    ([{"sketch_rows": 300, "sketch_profile_card_rows": 0},
      {"sketch_rows": 100, "sketch_profile_card_rows": 100}], 25.0),
], ids=["no_jobs", "no_counter", "no_rows", "all_card", "a_quarter"])
def test_sketch_profile_card_share_reader(counters, want):
    read = spec.load_reader("sketch_profile_card_share")
    assert read(_run(*counters)) == want


def test_sketch_profile_card_share_is_listed_for_the_sketch_cell():
    names = [m.name for m in spec.load_cell("nontargeted_pipeline").per_layer]
    assert names[-1] == "sketch_profile_card_share"
    for cell in ("targeted_pipeline", "long_pipeline"):
        assert "sketch_profile_card_share" not in [
            m.name for m in spec.load_cell(cell).per_layer]
