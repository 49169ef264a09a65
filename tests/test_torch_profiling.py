"""The port's span layer (``train/profiling.py``) on the CPU: nothing is
recorded and no range opened outside a profiler; inside one, the counts,
parents and self times, and the exported trace's range at the in-memory
start; spans cut by the profiler's start or stop left out; the spans of a
GBT fit and of ``main_train`` at their counts, the fit bit-identical to
the same fit unprofiled."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ae_waveforms_tpu_torch.classify.gbt import fit_gbt_sweep_margins
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet
from ae_waveforms_tpu_torch.train import profiling
from ae_waveforms_tpu_torch.train.loop import main_train

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    assert profiling.span("train.step") is profiling.span("gbt.hist")  # the one shared no-op
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    snap = profiling.snapshot()
    assert opened == [] and snap.stats == {} and snap.records == []


def test_counts_parents_self_times_and_the_trace_clock(tmp_path):
    with profile(activities=CPU) as prof:
        with profiling.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.001)
    snap = profiling.snapshot()
    outer, inner = snap.stats["outer"], snap.stats["inner"]
    assert (outer.count, inner.count) == (1, 2)
    assert [(r.name, r.parent) for r in snap.records] == [("inner", "outer"), ("inner", "outer"), ("outer", None)]
    assert inner.self_s == inner.total_s >= 0.002
    assert outer.self_s == pytest.approx(outer.total_s - inner.total_s, abs=1e-9)
    assert outer.self_s >= 0.002 and outer.total_s >= outer.self_s + 0.002
    start_ns = snap.records[-1].start_ns
    assert snap.records[-1].end_ns - start_ns == pytest.approx(outer.total_s * 1e9, abs=1)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ranges = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation" and e.get("name") == "outer"]
    assert len(ranges) == 1
    ts_us = float(ranges[0]["ts"]) + trace.get("baseTimeNanoseconds", 0) / 1e3
    assert abs(ts_us - start_ns / 1e3) < 2e3


def test_a_span_cut_by_the_profiler_is_not_counted():
    prof = profile(activities=CPU)
    before = profiling.span("entered_before")
    assert before is profiling.span("off")  # entered with the profiler off: the shared no-op
    with before:
        prof.start()
        with profiling.span("whole"):
            pass
        with profiling.span("exited_after"):
            prof.stop()
    snap = profiling.snapshot()
    assert set(snap.stats) == {"whole"} and [r.name for r in snap.records] == ["whole"]
    assert snap.records[0].parent is None


def _gbt_inputs(S=3, n=120, F=4, n_bins=16):
    g = torch.Generator().manual_seed(7)
    bins = torch.randint(0, n_bins, (n, F), generator=g, dtype=torch.int32)
    y = (torch.rand(n, generator=g) < 0.5).float()
    hp = dict(seeds=torch.arange(S) + 11, learning_rates=torch.full((S,), 0.3), gammas=torch.zeros(S),
              min_child_weights=torch.ones(S), subsamples=torch.full((S,), 0.8),
              colsamples=torch.full((S,), 0.75), n_actives=torch.full((S,), 4))
    return bins, y, torch.ones((S, n)), hp, n_bins


def test_gbt_fit_spans_count_levels_and_trees_and_change_nothing():
    bins, y, w, hp, n_bins = _gbt_inputs()
    trees, depth = 4, 3
    plain = fit_gbt_sweep_margins(bins, y, w, max_depth=depth, n_estimators=trees, n_bins=n_bins, **hp)
    with profile(activities=CPU):
        traced = fit_gbt_sweep_margins(bins, y, w, max_depth=depth, n_estimators=trees, n_bins=n_bins, **hp)
    counts = {k: v.count for k, v in profiling.snapshot().stats.items() if k.startswith("gbt.")}
    assert counts == {"gbt.grad": trees, "gbt.leaves": trees, "gbt.hist": trees * depth,
                      "gbt.split": trees * depth, "gbt.route": trees * depth}
    (ens_p, margin_p), (ens_t, margin_t) = plain, traced
    for a, b in zip(ens_p, ens_t):
        assert torch.equal(a, b)
    assert torch.equal(margin_p, margin_t)


def test_main_train_spans_count_steps_and_chunks(tmp_path):
    rng = np.random.default_rng(0)
    n = 96
    info = np.stack([np.repeat(np.arange(12) + 100, 8), np.arange(n)], 1).astype(np.float64)
    arrays = ArraySet(rng.standard_normal((n, 320)).astype(np.float32), np.zeros((n, 35), np.float32), info)
    cfg = TrainConfig(dataset_dir=str(tmp_path / "data"), results_dir=str(tmp_path / "results"),
                      model_class="LeNet5AutoencoderAvgPool", batch_size=16, validation_interval=2, dropout=0.1,
                      split_size_val=0.2, split_size_test=0.1, seed=0, plotting=False)
    steps = 3  # two chunks: step 0, then steps 1 and 2, each followed by a validation
    with profile(activities=CPU):
        main_train(cfg, arrays, max_steps=steps, device="cpu")
    stats = profiling.snapshot().stats
    for name in ("train.schedule", "train.step", "train.forward", "train.backward", "train.optimizer",
                 "adam.moments", "adam.update"):
        assert stats[name].count == steps, name
    for name in ("train.readback", "train.log", "train.validate"):
        assert stats[name].count == 2, name
    assert stats["train.checkpoint"].count >= 3  # the initial and final parameters, and each new best
    assert stats["train.step"].self_s < stats["train.step"].total_s
    parents = {r.name: r.parent for r in profiling.snapshot().records}
    assert parents["train.forward"] == parents["train.optimizer"] == "train.step"
    assert parents["adam.update"] == "train.optimizer" and parents["train.validate.batch"] == "train.validate"
