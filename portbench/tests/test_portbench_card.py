"""The reference on the card gives what it gives on the CPU."""
import random

import pytest
import torch

from portbench import reference


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(card):
    rng = random.Random(7)
    pairs = []
    for _ in range(64):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randrange(1, 700)))
        b = "".join(c for c in a if rng.random() > 0.03) + "ACGT"
        pairs.append((a, b))
    for hw in (False, True):
        cpu, _ = reference.edit_distances(pairs, hw, "cpu")
        gpu, _ = reference.edit_distances(pairs, hw, card)
        assert cpu.tolist() == gpu.tolist()
    sc = [(2, -3, 3, 1)] * len(pairs)
    assert (reference.semi_global_scores(pairs, sc, "cpu").tolist()
            == reference.semi_global_scores(pairs, sc, card).tolist())
