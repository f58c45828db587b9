"""The engine's launch-first loops: a round's batches (ED) and every
(Lb, Wp) chunk of an alignment round are all launched before the first
is collected, and are collected in launch order.

The ED and alignment loops against the same engine collecting each batch
as soon as it is launched.  Inputs are seeded; tolerance: exact.
"""
import numpy as np
import pytest
import torch

from isocon_tpu_torch.ops import engine as port_engine
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.parallel import Sharder
from test_torch_engine import _align_case, _ed_pairs

CPU = torch.device("cpu")


class _RecordingSharder(Sharder):
    """Records each launch and collect with its batch's size."""

    def __init__(self, devices):
        super().__init__(devices)
        self.calls = []

    def launch(self, fn, tensors, vectors, **kw):
        self.calls.append(("launch", len(vectors[0])))
        return super().launch(fn, tensors, vectors, **kw)

    def collect(self, batch):
        self.calls.append(("collect", batch.B))
        return super().collect(batch)


class _EagerSharder(Sharder):
    """Collects each batch as it is launched: one chunk at a time."""

    def launch(self, fn, tensors, vectors, **kw):
        return super().collect(super().launch(fn, tensors, vectors, **kw))

    def collect(self, result):
        return result


def _engines(n):
    mesh = [CPU] * n
    return (PairEngine(device="cpu", sharder=_RecordingSharder(mesh)),
            PairEngine(device="cpu", sharder=_EagerSharder(mesh)))


def _first_collect(calls):
    return [c[0] for c in calls].index("collect")


@pytest.mark.parametrize("n, case", [(1, (5, False)), (1, (9, True)),
                                     (2, (5, False))],
                         ids=["1-overflow", "1-drift", "2-overflow"])
def test_align_launch_first_equals_one_chunk_at_a_time(monkeypatch, n,
                                                       case):
    """Chunks of 4 pairs (so a round has several), on a case whose bands
    overflow and double and on one whose paths leave the band without
    touching its edge: the same triples and counters either way, and
    every chunk of the first round is launched before the first
    collect, then collected in launch order."""
    monkeypatch.setattr(port_engine, "ALIGN_BATCH", 4)
    seed, drift = case
    pairs, scores = _align_case(seed, drift=drift)
    fast, eager = _engines(n)
    got = fast.align_pairs(pairs, scores)
    want = eager.align_pairs(pairs, scores)
    assert got == want
    assert (fast.counters["align_overflows"] > 0) == (not drift)
    for key, value in eager.counters.items():
        if not key.endswith("seconds"):
            assert fast.counters[key] == value, key
    calls = fast.sharder.calls
    first = _first_collect(calls)
    assert first > 2
    assert all(kind == "launch" and b <= 4 for kind, b in calls[:first])
    sizes = [b for kind, b in calls[first:2 * first] if kind == "collect"]
    assert len(sizes) == first
    assert sizes == [b for _k, b in calls[:first]]


@pytest.mark.parametrize("n", [1, 2])
def test_ed_launch_first_equals_one_batch_at_a_time(n):
    """The ED loop on three pool widths, NW with caps and HW, and (one
    block) NW without caps, which escalates to the full window: the same
    distances, end columns, counters and rungs as collecting each batch
    at its launch; a round's batches are launched before the first is
    collected, and collected in launch order."""
    pairs = _ed_pairs(4)
    caps = np.random.default_rng(2).integers(0, 150, len(pairs))
    fast, eager = _engines(n)
    calls = ((caps, False), (caps // 4, True)) + (
        ((None, False),) if n == 1 else ())
    for k, hw_mode in calls:
        got = fast.edit_distances(pairs, k_cap=k, hw_mode=hw_mode)
        want = eager.edit_distances(pairs, k_cap=k, hw_mode=hw_mode)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1][want[0] >= 0],
                                      want[1][want[0] >= 0])
    assert (fast.counters["ed_pairs_full_window"] > 0) == (n == 1)
    for key, value in eager.counters.items():
        if not key.endswith("seconds"):
            assert fast.counters[key] == value, key
    assert fast.myers_rungs == eager.myers_rungs
    assert _first_collect(fast.sharder.calls) >= 2
    collected = [b for kind, b in fast.sharder.calls if kind == "collect"]
    launched = [b for kind, b in fast.sharder.calls if kind == "launch"]
    assert collected == launched
