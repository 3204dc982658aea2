"""The controls fail the limits: the reference put in the program's
place, one precision below what the configuration states, on the chip at
each cell's own size and on three seeds; in the training cell also the
fault planted in it, half of each batch left out.  Marked ``cuda``: they skip without a card."""

from __future__ import annotations

import pytest
import torch

from padbench import limits
from padbench.harness import Manifest
from padbench.tests.tiny import REPO

SEEDS = (2 ** 31 + 5, 77, 4_000_000_001)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["score.vit_b16_mlp_head.b128",
                                  "eval_f32.vit_b16_linear_head.b32"])
def test_scoring_control_fails(cell):
    dev = _card()
    m = Manifest(REPO)
    if cell not in m.cells:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    lim = m.workload(cell)["limits"]
    for seed in SEEDS:
        got = limits.control_scores(m, cell, seed, dev)
        assert any(got[k] > lim[k] for k in lim), (seed, got, lim)


@pytest.mark.cuda
def test_training_control_and_faults_fail():
    dev = _card()
    m = Manifest(REPO)
    cell = "train.vit_b16_mlp_head.b128"
    if cell not in m.cells:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    lim = m.workload(cell)["limits"]
    for seed in SEEDS:
        for name, got in limits.control_training(m, cell, seed, dev,
                                                 True).items():
            assert any(got[k] > lim[k] for k in lim), (seed, name, got)
