"""The reader of stat_row_reuse_share, on the CPU."""
from types import SimpleNamespace

from portbench import spec


def _run(*counters):
    return SimpleNamespace(jobs=[SimpleNamespace(counters_end=c)
                                 for c in counters])


def test_stat_row_reuse_share_reads_the_engine_counters():
    read = spec.load_reader("stat_row_reuse_share")
    assert read(_run()) is None
    assert read(_run({"upload_bytes": 1})) is None        # an older engine
    assert read(_run({"stat_rows_built": 0, "stat_rows_used": 0})) is None
    got = read(_run({"stat_rows_built": 2453, "stat_rows_used": 29918},
                    {"stat_rows_built": 47, "stat_rows_used": 82}))
    assert got == 100.0 * (1.0 - 2500 / 30000)


def test_both_cells_report_it():
    for name in ("targeted_pipeline", "long_pipeline"):
        cell = spec.load_cell(name)
        assert "stat_row_reuse_share" in [m.name for m in cell.per_layer]
