"""``tree_host_ms.gbt`` on a fake snapshot: the per-tree spans' host
seconds over the traced trees, with or without ``gbt.masks``, and None
where no tree was counted or the program records no spans."""

from types import SimpleNamespace

import pytest

from ae_waveforms_tpu_torch.train import profiling
from portbench.bench import Spec
from portbench.run import Reading
from portbench.trace import Trace

METRIC, CELL = "tree_host_ms.gbt", "lstm_ae.gbt_search"
TREES = {"gbt.grad": profiling.SpanStats(count=30, total_s=0.006, self_s=0.006),
         "gbt.leaves": profiling.SpanStats(count=30, total_s=0.003, self_s=0.003),
         "gbt.split": profiling.SpanStats(count=240, total_s=0.24, self_s=0.24)}


def _read(monkeypatch, stats):
    monkeypatch.setattr(profiling, "snapshot", lambda: SimpleNamespace(stats=dict(stats), records=[]))
    cell = Spec().cell(CELL)
    return cell.reader(METRIC).read(Reading(cell=cell, device_name="cpu", trace=Trace(window_s=2.0), records={}))


def test_the_cell_lists_the_metric():
    assert [m["name"] for m in Spec().cell(CELL).per_layer].count(METRIC) == 1


@pytest.mark.parametrize("masks_s,want", [(None, 0.3), (0.057, 0.3 + 1.9)], ids=["without_masks", "with_masks"])
def test_host_ms_a_tree(monkeypatch, masks_s, want):
    stats = dict(TREES)
    if masks_s is not None:
        stats["gbt.masks"] = profiling.SpanStats(count=30, total_s=masks_s, self_s=masks_s)
    assert _read(monkeypatch, stats) == pytest.approx(want)


def test_none_without_a_tree(monkeypatch):
    assert _read(monkeypatch, {**TREES, "gbt.leaves": profiling.SpanStats()}) is None
    assert _read(monkeypatch, {"gbt.split": TREES["gbt.split"]}) is None


def test_none_where_the_program_has_no_spans(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    cell = Spec().cell(CELL)
    assert cell.reader(METRIC).read(Reading(cell=cell, device_name="cpu", trace=None, records={})) is None
