"""The reader of ``graph_step_share.train`` on fake snapshots of the
program's spans: the share of ``train.step`` spans that hold a
``train.replay``, 0 where the program replays no step (as a program
without the step graph), None where no step was counted or the program
records no spans."""

from types import SimpleNamespace

import pytest

from ae_waveforms_tpu_torch.train import profiling
from portbench.bench import Spec
from portbench.run import Reading
from portbench.trace import Trace

METRIC, CELL = "graph_step_share.train", "lstm_ae.train"


def _read(monkeypatch, stats):
    monkeypatch.setattr(profiling, "snapshot", lambda: SimpleNamespace(stats=dict(stats), records=[]))
    cell = Spec().cell(CELL)
    return cell.reader(METRIC).read(Reading(cell=cell, device_name="cpu", trace=Trace(window_s=2.0), records={}))


def test_the_cell_lists_the_metric_once():
    assert [m["name"] for m in Spec().cell(CELL).per_layer].count(METRIC) == 1
    assert all(METRIC not in [m["name"] for m in Spec().cell(c).per_layer] for c in ("lstm_ae.gbt_search",))


@pytest.mark.parametrize("replays,share", [(200, 100.0), (150, 75.0), (0, 0.0), (None, 0.0)])
def test_share_of_replayed_steps(monkeypatch, replays, share):
    stats = {"train.step": profiling.SpanStats(count=200, total_s=0.1, self_s=0.02),
             "train.readback": profiling.SpanStats(count=1, total_s=0.001, self_s=0.001)}
    if replays is not None:
        stats["train.replay"] = profiling.SpanStats(count=replays, total_s=0.05, self_s=0.05)
    assert _read(monkeypatch, stats) == pytest.approx(share)


def test_none_without_a_step(monkeypatch):
    assert _read(monkeypatch, {"train.step": profiling.SpanStats()}) is None
    assert _read(monkeypatch, {"gbt.split": profiling.SpanStats(count=3, total_s=0.1, self_s=0.1)}) is None


def test_none_where_the_program_has_no_spans(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    cell = Spec().cell(CELL)
    assert cell.reader(METRIC).read(Reading(cell=cell, device_name="cpu", trace=Trace(), records={})) is None
