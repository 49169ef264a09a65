"""The readers of the program's spans, on a fake snapshot: the means over
each span's own count, the share of the traced window, and None where a
span has no count or the program records no spans."""

from types import SimpleNamespace

import pytest

from ae_waveforms_tpu_torch.train import profiling
from portbench.bench import Spec
from portbench.run import Reading
from portbench.trace import Trace

STATS = {
    "train.step": profiling.SpanStats(count=200, total_s=0.9, self_s=0.1),
    "train.readback": profiling.SpanStats(count=1, total_s=0.05, self_s=0.05),
    "train.log": profiling.SpanStats(count=1, total_s=0.002, self_s=0.002),
    "train.validate": profiling.SpanStats(count=1, total_s=0.1, self_s=0.01),
    "gbt.split": profiling.SpanStats(count=240, total_s=0.24, self_s=0.24),
    "gbt.hist": profiling.SpanStats(count=240, total_s=0.06, self_s=0.06),
    "gbt.route": profiling.SpanStats(count=200, total_s=0.02, self_s=0.02),
}
CELLS = {"step_host_ms.train": "lstm_ae.train", "chunk_extras_share.train": "lstm_ae.train",
         "split_host_ms.gbt": "lstm_ae.gbt_search", "kernel_call_host_ms.gbt": "lstm_ae.gbt_search"}


def _read(metric: str, window_s: float = 2.0):
    cell = Spec().cell(CELLS[metric])
    trace = Trace(window_s=window_s)
    return cell.reader(metric).read(Reading(cell=cell, device_name="cpu", trace=trace, records={}))


def _fake(monkeypatch, stats):
    monkeypatch.setattr(profiling, "snapshot", lambda: SimpleNamespace(stats=dict(stats), records=[]))


def test_each_cell_lists_its_span_metrics():
    assert {m: [x["name"] for x in Spec().cell(c).per_layer].count(m) for m, c in CELLS.items()} == dict.fromkeys(
        CELLS, 1)


def test_readings_of_a_fake_snapshot(monkeypatch):
    _fake(monkeypatch, STATS)
    assert _read("step_host_ms.train") == pytest.approx(4.5)
    assert _read("chunk_extras_share.train") == pytest.approx(100 * 0.152 / 2.0)
    assert _read("split_host_ms.gbt") == pytest.approx(1.0)
    assert _read("kernel_call_host_ms.gbt") == pytest.approx(1e3 * 0.08 / 440)


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_none_without_a_count(monkeypatch, metric):
    _fake(monkeypatch, {k: profiling.SpanStats() for k in STATS})
    assert _read(metric) is None


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_none_where_the_program_has_no_spans(monkeypatch, metric):
    monkeypatch.delattr(profiling, "snapshot")
    assert _read(metric) is None


def test_no_share_without_a_window(monkeypatch):
    _fake(monkeypatch, STATS)
    assert _read("chunk_extras_share.train", window_s=0.0) is None
