"""Tests of the benchmark itself, on the CPU at small sizes; those marked
``cuda`` need the card and skip elsewhere (run them there with
``python3 -m pytest portbench/tests -m cuda -q``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control's TF32 exists only on the card")
    return torch.device("cuda:0")
