"""The ``lstm_classifier.sweep`` cell: found by name with its configuration
and metrics; a small run of its driver on the CPU (set-up, window, check)
is correct, and a fault planted under the entry the window drives makes
it incorrect.

The small run keeps the model's widths and T = 320 and shrinks the rest:
40 beats a class, 10 of them test rows, size 30 (48 training rows a seed),
3 seeds, B = 16 (the configuration's batch size, which the driver passes
into the call), so an epoch is 3 stacked steps, and 2 epochs.
Its AUC limit is wider than the cell's: after two epochs of three steps at
lr 1e-4 the 20 test probabilities lie within float32 rounding of each
other, so the program's float32 and the reference's float64 can order a
pair of them differently, 0.01 of the AUC a pair (1/(10 x 10)); the 12
validation rows a seed, 6 a class, make a pair 1/36 of the validation
AUC."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.bench import Spec, load_json
from portbench.drivers.dl_sweep import Recorder, selected
from portbench.run import Reading
from portbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2**31 + 7
CELL = "lstm_classifier.sweep"
METRICS = ["train_mfu", "idle_share.train", "step_ms.dl", "epoch_extras_share.dl", "lstm_ms.dl"]


def small_cell():
    s = Spec()
    config = load_json(s.root / "portbench/configs/lstm_classifier.json")
    traffic = load_json(s.root / "portbench/traffic/lstm_classifier.sweep.json")
    config.update(beats_per_class=40, test_per_class=10, batch_size=16)
    traffic.update(size=30, seeds=3, seed_chunk=3, epochs=2, trace_steps=[1, 4], check_block=2)
    traffic["limits"] = dict(traffic["limits"], auc_err=0.03, val_auc_err=0.06)
    return s.cell(CELL, traffic=traffic, config=config)


def test_found_by_name():
    cell = Spec().cell(CELL)
    assert cell.config["name"] == "lstm_classifier" and cell.driver == "dl_sweep"
    assert cell.driver_module().__file__.endswith("portbench/drivers/dl_sweep.py")
    assert [m["name"] for m in cell.end_to_end] == ["train_beats_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert set(cell.traffic["limits"]) <= set(cell.driver_module().NUMBERS)
    empty = Reading(cell=cell, device_name="cpu", trace=None, records={})
    assert all(cell.reader(m).read(empty) is None for m in METRICS)


def test_lstm_ms_reads_the_rnn_kernels_a_step():
    cell = Spec().cell(CELL)
    ops = [("void_RNN_blockPersist_fp_LSTM_float", 0.0, 3000.0),
           ("void_GENERIC_elementWise_bp2_float__cudnnRNNBiasMode", 5000.0, 1000.0), ("sgemm_128x64", 9000.0, 4000.0)]
    run = Reading(cell=cell, device_name="gpu", trace=Trace(ops=ops), records={"traced_steps": 2})
    assert cell.reader("lstm_ms.dl").read(run) == pytest.approx(2.0)  # (3 + 1) ms over 2 steps


def test_selection_replays_early_stopping():
    """Patience 1, min_delta 0.01, two seeds: both improve in epoch 0; in
    epoch 1 seed 0 does and seed 1 (by 0.005) does not, so seed 1 stops;
    epoch 2 reads seed 0 alone, which does not improve."""
    rec = Recorder({"batch_size": 4, "patience": 1, "min_delta": 0.01})
    rec.inputs = (None, None, None, None, [0, 1])
    rec.snapshots = [{}] * 3
    rec.val_aucs = [torch.tensor(v) for v in (0.6, 0.7, 0.65, 0.705, 0.64)]
    pick, table = selected(rec)
    assert pick.tolist() == [1, 0] and np.isnan(table[2, 1]) and table[2, 0] == pytest.approx(0.64)
    rec.val_aucs = rec.val_aucs[:4]  # an AUC missing: the reads do not fit the rule
    assert selected(rec) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(trace):
    result = run.run_cell(small_cell(), SEED, 1.0, bool(trace), CPU)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 3 * 2 * 3  # seeds x epochs x steps
    assert set(result["compared"]) == set(small_cell().driver_module().NUMBERS)
    if trace:  # the spans read on the CPU; the device metrics do not
        assert set(result["metrics"]) == {"step_ms.dl", "epoch_extras_share.dl"}


class _Backward(torch.autograd.Function):
    """The identity forward; its backward passes the gradient through
    ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


FAULTS = {  # a planted fault: the number that alone has to see it, or None
    "half_batch": None, "unchanged": None, "altered": None,
    "rounded": "lstm_gap",  # each LSTM's outputs kept to bfloat16, a precision lower than TF32's
    "rounded_backward": "lstm_grad_gap",  # the gradient into each LSTM's outputs kept to bfloat16
    "scaled_head_backward": "head_grad_gap",  # the gradient out of each dense layer of the head made 1.5 times larger
    "no_snapshot": "select_err",  # the best snapshot never taken: the initial weights returned
    "wrong_rows": "val_auc_err",  # the validation AUC of the scores against the rows in reverse order
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails(monkeypatch, fault):
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.models import lstm_classifier as lc
    from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

    lstm_forward, dense = lc.lstm_forward, lc._dense
    if fault == "rounded":
        def rounded(lstm, x):
            out, state = lstm_forward(lstm, x)
            return out.bfloat16().to(out.dtype), state

        monkeypatch.setattr(lc, "lstm_forward", rounded)
    elif fault == "rounded_backward":
        def rounded_backward(lstm, x):
            out, state = lstm_forward(lstm, x)
            return _Backward.apply(out, lambda g: g.bfloat16().to(g.dtype)), state

        monkeypatch.setattr(lc, "lstm_forward", rounded_backward)
    elif fault == "scaled_head_backward":
        monkeypatch.setattr(lc, "_dense", lambda x, w, b: _Backward.apply(dense(x, w, b), lambda g: 1.5 * g))
    elif fault == "no_snapshot":
        monkeypatch.setattr(StackedConfigs, "take_", lambda self, snap, mask: None)
    elif fault == "wrong_rows":
        roc = dl._roc_auc_device
        monkeypatch.setattr(dl, "_roc_auc_device", lambda scores, y, valid: roc(scores.flip(0), y, valid))
    elif fault == "half_batch":
        batch_bce = dl.batch_bce

        def halved(model, x, y, idx, mask, *args):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
            return batch_bce(model, x, y, idx, mask, *args)

        monkeypatch.setattr(dl, "batch_bce", halved)
    elif fault == "unchanged":
        monkeypatch.setattr(dl._Adam, "step", lambda self, closure=None: None)
    else:
        predict = dl.predict

        def altered(models, X, device=None):
            probs = predict(models, X, device=device)
            probs[:, 0] += 1e-3
            return probs

        monkeypatch.setattr(dl, "predict", altered)
    result = run.run_cell(small_cell(), SEED, 1.0, False, CPU)
    assert result["correct"] is False
    if FAULTS[fault]:
        number = result["compared"][FAULTS[fault]]
        assert number["value"] > number["limit"], result["compared"]
