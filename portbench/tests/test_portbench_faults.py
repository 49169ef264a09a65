"""The check fails a broken timed path: each run here skips the look for a
card, drives the rest of a run at a small size with a fault planted under
the entry the window drives, and sees ``correct`` come out false.  One
chip: there is no exchange between chips to leave out."""

import pytest
import torch

from portbench import run
from portbench.drivers.train import altered_row
from portbench.tests.small import small_cell

CPU = torch.device("cpu")
SEED = 2**31 + 99


def correct(cell) -> bool:
    return run.run_cell(cell, SEED, 1.0, False, CPU)["correct"]


def test_sound_runs_are_correct():
    assert correct(small_cell("conv_ae.train"))
    assert correct(small_cell("lstm_ae.train"))
    assert correct(small_cell("lstm_ae.gbt_search"))


def test_train_step_leaves_state_unchanged(monkeypatch):
    from ae_waveforms_tpu_torch.train import loop

    step = loop.train_step

    def unchanged(model, optimizer, *args, **kwargs):
        before = [p.detach().clone() for p in model.parameters()]
        loss = step(model, optimizer, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    monkeypatch.setattr(loop, "train_step", unchanged)
    assert not correct(small_cell("conv_ae.train"))


def test_train_half_batch_left_out(monkeypatch):
    from ae_waveforms_tpu_torch.train import loop

    batch_loss = loop.batch_loss

    def halved(model, data_x, idx, mask, *args, **kwargs):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return batch_loss(model, data_x, idx, mask, *args, **kwargs)

    monkeypatch.setattr(loop, "batch_loss", halved)
    assert not correct(small_cell("conv_ae.train"))


@pytest.mark.parametrize("name", ["lstm_ae.train", "conv_ae.train"])
def test_validation_answer_altered(monkeypatch, name):
    """The first row's latent altered where the eval forward makes it: in
    K3 for the LSTM AE, in the encoder for the conv AE."""
    if name == "lstm_ae.train":
        from ae_waveforms_tpu_torch.ops import lstm_encoder

        encode = lstm_encoder.encode_fused
        monkeypatch.setattr(lstm_encoder, "encode_fused", lambda params, x: altered_row(encode(params, x)))
    else:
        from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool

        encode = LeNet5AutoencoderAvgPool.encode

        def altered(self, x, *args, **kwargs):
            z = encode(self, x, *args, **kwargs)
            return z if self.training else altered_row(z)

        monkeypatch.setattr(LeNet5AutoencoderAvgPool, "encode", altered)
    assert not correct(small_cell(name))


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_gbt_faults(monkeypatch, fault):
    from ae_waveforms_tpu_torch.classify import harness

    fit = harness.fit_gbt_sweep_margins

    def broken(bins, y, row_weights, *args, **kwargs):
        if fault == "half":
            row_weights = row_weights.clone()
            row_weights[:, : row_weights.shape[1] // 2] = 0.0
            return fit(bins, y, row_weights, *args, **kwargs)
        ens, margins = fit(bins, y, row_weights, *args, **kwargs)
        return ens, margins + 1e-3

    monkeypatch.setattr(harness, "fit_gbt_sweep_margins", broken)
    assert not correct(small_cell("lstm_ae.gbt_search"))
