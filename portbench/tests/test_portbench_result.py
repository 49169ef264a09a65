"""The run's result line, and the run's refusals."""

import json
import sys

import pytest
import torch

from portbench import run
from portbench.tests.small import small_cell

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_fields_in_order(trace):
    result = run.run_cell(small_cell("conv_ae.train"), 2**31 + 5, 1.0, bool(trace), CPU)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["compared"]) == {"loss_gap", "grad_gap", "change_gap", "val_recon_gap"}
    if trace:
        assert result["metrics"] == {}  # a CPU run writes no device metric
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"train_beats_per_s", "setup_s"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "lstm_ae.train", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


FAKE = {"correct": True, "attempted": 3, "failed": 0, "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
        "device": {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1},
        "compared": {"loss_gap": {"value": 1e-7, "limit": 1e-5}}}


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: dict(FAKE))


def test_last_line_is_the_result(monkeypatch, capsys):
    _fake_card(monkeypatch)
    assert run.main(["--workload", "lstm_ae.train", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == FAKE
    assert err.strip().splitlines()[-1] == "compared loss_gap 1e-07 limit 1e-05"


def test_jax_loaded_no_result(monkeypatch, capsys):
    _fake_card(monkeypatch)
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.main(["--workload", "lstm_ae.train", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax.numpy" in err
