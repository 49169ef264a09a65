"""The DL classifier's spans (``classify/dl.py``) on the CPU: under
``torch.profiler`` a stacked step of S seeds counts ``dl.step`` and
``dl.optimizer`` once and ``dl.seed`` S times, and an epoch of
``_train_chunk`` counts ``dl.validate`` and ``dl.select`` once, inside
nothing but themselves; with the profiler off nothing is counted."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ae_waveforms_tpu_torch.classify import dl
from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
from ae_waveforms_tpu_torch.train import profiling
from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

T = 16
NAMES = ("dl.step", "dl.seed", "dl.optimizer", "dl.validate", "dl.select")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def counts():
    stats = profiling.snapshot().stats
    return {name: stats[name].count for name in NAMES if name in stats}


def step(S: int) -> None:
    stacked = StackedConfigs(LSTMClassifier(device="cpu").train(),
                             [LSTMClassifier(generator=torch.Generator().manual_seed(s), device="cpu") for s in range(S)],
                             "cpu")
    optimizer = dl._Adam(stacked.param_groups(), lr=1e-4)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((S, 8, T, 1), generator=g)
    y = (torch.rand((S, 8), generator=g) < 0.5).float()
    idx = torch.arange(8).expand(S, 8)
    mask = torch.ones((S, 8), dtype=torch.bool)
    dl.stacked_step(stacked, optimizer, list(range(S)), x, y, idx, mask,
                    [torch.Generator().manual_seed(s) for s in range(S)], 0.2, None)


@pytest.mark.parametrize("S", [1, 3])
def test_a_stacked_step(S):
    with profile(activities=[ProfilerActivity.CPU]):
        step(S)
    assert counts() == {"dl.step": 1, "dl.seed": S, "dl.optimizer": 1}
    parents = {r.name: r.parent for r in profiling.snapshot().records if r.name in NAMES}
    assert parents == {"dl.seed": "dl.step", "dl.optimizer": "dl.step", "dl.step": None}


def test_an_epoch():
    rng = np.random.default_rng(1)
    S, n, m = 2, 12, 6
    Xs = rng.standard_normal((S, n, T, 1)).astype(np.float32)
    Xvs = rng.standard_normal((S, m, T, 1)).astype(np.float32)
    ys = np.tile(np.r_[np.zeros(n // 2), np.ones(n // 2)], (S, 1))
    yvs = np.tile(np.r_[np.zeros(m // 2), np.ones(m // 2)], (S, 1))
    with profile(activities=[ProfilerActivity.CPU]):
        dl._train_chunk(Xs, ys, Xvs, yvs, [0, 1], 1, batch_size=8, patience=50, min_delta=5e-4, remat_chunk=None,
                        device=torch.device("cpu"), init=None, dropout_rate=0.2)
    assert counts() == {"dl.step": 2, "dl.seed": 4, "dl.optimizer": 2, "dl.validate": 1, "dl.select": 1}
    parents = {r.name: r.parent for r in profiling.snapshot().records if r.name in ("dl.validate", "dl.select")}
    assert parents == {"dl.validate": None, "dl.select": None}


def test_nothing_counted_with_the_profiler_off():
    step(2)
    assert counts() == {} and profiling.snapshot().records == []
