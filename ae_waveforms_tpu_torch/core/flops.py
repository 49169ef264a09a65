"""Analytic FLOP counts of the trained programs, and the card's peak rates
(the port of the JAX package's ``core/flops.py``).

Pure Python: ``chip_smoke.py`` prints an MFU beside each training step's
time with these.

Conventions (the standard MFU accounting):
- one multiply-add = 2 FLOPs;
- only matmul/conv FLOPs count ("useful" model FLOPs) — elementwise,
  gather, and reduction work is excluded, so MFU is a lower bound;
- a training step costs 3x the forward matmul FLOPs (backward needs two
  matmuls per forward matmul);
- the denominator is the card's float32 peak outside the tensor cores: the
  port runs every product in full float32 (cuDNN inside ``cudnn_fp32``,
  matmuls at torch's "highest" precision), so neither the TF32 nor the
  bf16 tensor-core rate is within its reach.

Reference workloads these model: the AE training step
(functions_ae/run_train.py:282-364 at main_ae.py:58-66 defaults) and the
DL-classifier epoch (main_dl_classify.py:63-105).
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "lstm_layer_fwd_flops", "lstm_ae_fwd_flops_per_sample",
    "lstm_ae_train_flops_per_sample", "conv_ae_fwd_flops_per_sample",
    "conv_ae_train_flops_per_sample", "dl_classifier_fwd_flops_per_sample",
    "dl_classifier_train_flops_per_model_epoch",
    "PEAKS", "device_peak", "device_peak_flops", "mfu",
]

#: dense peak rates by ``torch.cuda.get_device_name()`` (NVIDIA's data
#: sheets, at the card's full power limit): FLOP/s by type, device-memory
#: bytes/s.  "NVIDIA H100 80GB HBM3" is the H100 SXM5 at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 494.7e12, "bf16": 989.4e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peak(name: Optional[str] = None) -> dict:
    """The peak rates of the card called ``name`` (the current CUDA
    device's name when None); an unknown card raises ``KeyError``."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name()
    if name not in PEAKS:
        raise KeyError(f"no peak rates for {name!r}; known cards: {sorted(PEAKS)}")
    return PEAKS[name]


def device_peak_flops(name: Optional[str] = None, dtype: str = "float32") -> float:
    """Peak FLOP/s of the card ``name`` for ``dtype`` ("float32", "tf32",
    "bf16")."""
    return device_peak(name)[dtype]


def lstm_layer_fwd_flops(T: int, d_in: int, d_h: int) -> int:
    """One LSTM layer forward, one sample: T steps of the input projection
    (d_in -> 4*d_h) and the recurrent projection (d_h -> 4*d_h)."""
    return 2 * T * 4 * d_h * (d_in + d_h)


def lstm_ae_fwd_flops_per_sample(T: int = 320, latent: int = 10,
                                 h1: int = 128, h2: int = 64) -> int:
    """models/lstm_ae.py: enc 1->h1->h2->latent, dec latent->h2->h1->1."""
    return (
        lstm_layer_fwd_flops(T, 1, h1)
        + lstm_layer_fwd_flops(T, h1, h2)
        + lstm_layer_fwd_flops(T, h2, latent)
        + lstm_layer_fwd_flops(T, latent, h2)
        + lstm_layer_fwd_flops(T, h2, h1)
        + lstm_layer_fwd_flops(T, h1, 1)
        + 2 * T  # the 1x1 output linear
    )


def lstm_ae_train_flops_per_sample(T: int = 320, latent: int = 10) -> int:
    return 3 * lstm_ae_fwd_flops_per_sample(T, latent)


def _conv_flops(k: int, c_in: int, c_out: int, l_out: int) -> int:
    return 2 * k * c_in * c_out * l_out


def conv_ae_fwd_flops_per_sample(latent: int = 10) -> int:
    """models/conv_ae.py at T=320 (lengths pinned by the upsample sizes);
    transpose convs counted over their INPUT length (each input column
    feeds k outputs)."""
    enc = (
        _conv_flops(3, 1, 16, 160) + _conv_flops(3, 16, 32, 40)
        + _conv_flops(3, 32, 64, 10) + _conv_flops(3, 64, 128, 3)
        + _conv_flops(1, 128, latent, 1)
    )
    dec = (
        _conv_flops(1, latent, 128, 1) + _conv_flops(3, 128, 64, 3)
        + _conv_flops(3, 64, 32, 10) + _conv_flops(3, 32, 16, 40)
        + _conv_flops(3, 16, 1, 160)
    )
    return enc + dec


def conv_ae_train_flops_per_sample(latent: int = 10) -> int:
    return 3 * conv_ae_fwd_flops_per_sample(latent)


def dl_classifier_fwd_flops_per_sample(T: int = 320) -> int:
    """models/lstm_classifier.py: LSTM 1->128->64->64, attention linear
    64->1 per step, fc 64->32->1."""
    return (
        lstm_layer_fwd_flops(T, 1, 128)
        + lstm_layer_fwd_flops(T, 128, 64)
        + lstm_layer_fwd_flops(T, 64, 64)
        + 2 * T * 64  # attention scores
        + 2 * 64 * 32 + 2 * 32  # head
    )


def dl_classifier_train_flops_per_model_epoch(
    n_train: int = 3200, n_val: int = 800, T: int = 320
) -> int:
    """One epoch of one model: train fwd+bwd over the epoch's samples +
    the validation forward."""
    f = dl_classifier_fwd_flops_per_sample(T)
    return 3 * f * n_train + f * n_val


def mfu(achieved_flops_per_s: float, name: Optional[str] = None) -> float:
    """Achieved FLOP/s over the card's float32 peak."""
    return achieved_flops_per_s / device_peak_flops(name, "float32")
