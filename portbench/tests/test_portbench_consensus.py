"""The reader of consensus_card_share, on the CPU."""
from types import SimpleNamespace

from portbench import spec


def _run(*counters):
    return SimpleNamespace(jobs=[SimpleNamespace(counters_end=c)
                                 for c in counters])


def test_consensus_card_share_reads_the_engine_counters():
    read = spec.load_reader("consensus_card_share")
    assert read(_run()) is None
    assert read(_run({"upload_bytes": 1})) is None        # an older engine
    none = {"consensus_rows_card": 0, "consensus_rows_host": 0}
    assert read(_run(none)) is None
    got = read(_run({"consensus_rows_card": 90, "consensus_rows_host": 6},
                    {"consensus_rows_card": 100, "consensus_rows_host": 4}))
    assert got == 100.0 * 190 / 200
