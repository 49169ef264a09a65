"""Recurrent autoencoder as an ``nn.Module`` (the port of the JAX package's
``models/lstm_ae.py``).

Encoder: LSTM 1->128 -> dropout -> LSTM 128->64 -> dropout -> LSTM
64->latent; the latent code is the final hidden state of the last LSTM.
Decoder: latent repeated across the T steps -> LSTM latent->64 -> dropout
-> LSTM 64->128 -> dropout -> LSTM 128->1 -> Linear(1, 1).

In ``eval()`` mode the encoder runs through the fused encoder kernel
(``ops.lstm_encoder.encode_fused``), which has no backward and no dropout:
call it under ``torch.no_grad()``.  In ``train()`` mode the encoder runs
through its ``torch.nn.LSTM`` layers, so gradients reach its weights, with
dropout between them.  The decoder always runs through ``torch.nn.LSTM``
layers (in the JAX package it is a plain scan outside any kernel).  Every
cuDNN LSTM runs in full float32 (``cudnn_fp32``); the trainer runs the
backward pass inside it too (``train.loop.train_step``).  Dropout draws from the
``generator`` the caller passes, never from global RNG state.

Input layout (B, T, 1).  ``jax_tree`` names the parameters as the JAX
package does, which is how checkpoints and the bridge carry them across.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.models.layers import copy_tree_, dropout, linear_init, lstm_forward, lstm_init
# the module, not the name: ops.lstm_encoder imports models.layers, whose
# package imports this module, so either may be imported first
from ae_waveforms_tpu_torch.ops import lstm_encoder

__all__ = ["LSTMAutoencoder"]

_LSTM_NAMES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}


class LSTMAutoencoder(nn.Module):
    def __init__(
        self,
        latent_size: int = 10,
        hidden_sizes: Tuple[int, int] = (128, 64),
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """Weights are drawn from ``generator`` (seed 0 when None) with
        torch's uniform(+-1/sqrt(H)) init, layer by layer in the JAX
        package's order enc1..enc3, dec1..dec3, out.  The module lives on
        ``device``: the first CUDA device unless named (``resolve_device``)."""
        super().__init__()
        h1, h2 = hidden_sizes
        self.sizes = {
            "enc1": (1, h1), "enc2": (h1, h2), "enc3": (h2, latent_size),
            "dec1": (latent_size, h2), "dec2": (h2, h1), "dec3": (h1, 1),
        }
        # built on the meta device, so torch's own init draws nothing from
        # the global generator; the weights are filled below
        for name, (i, h) in self.sizes.items():
            setattr(self, name, nn.LSTM(i, h, batch_first=True, device="meta"))
        self.out = nn.Linear(1, 1, device="meta")
        self.to_empty(device=resolve_device(device))
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        tree = {name: lstm_init(g, i, h) for name, (i, h) in self.sizes.items()}
        tree["out"] = linear_init(g, 1, 1)
        self.load_jax_tree(tree)

    def jax_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters under the JAX package's names (no copies)."""
        tree = {
            name: {k: getattr(getattr(self, name), v) for k, v in _LSTM_NAMES.items()}
            for name in self.sizes
        }
        tree["out"] = {"w": self.out.weight, "b": self.out.bias}
        return tree

    def load_jax_tree(self, tree) -> None:
        """Copy a JAX-named parameter tree (arrays or tensors) in."""
        copy_tree_(self.jax_tree(), tree)

    def encode(self, x: torch.Tensor, rate: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, 1) -> latent (B, latent): through the fused kernel in
        eval mode; through ``enc1..enc3`` with dropout ``rate`` after enc1
        and enc2 in train mode."""
        if not self.training:
            return lstm_encoder.encode_fused(self.jax_tree(), x)
        with cudnn_fp32():
            h, _ = lstm_forward(self.enc1, x)
            h = dropout(h, rate, generator, True)
            h, _ = lstm_forward(self.enc2, h)
            h = dropout(h, rate, generator, True)
            _, (z, _) = lstm_forward(self.enc3, h)
        return z[0]

    def decode(self, z: torch.Tensor, seq_len: int, rate: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """latent (B, latent) -> reconstruction (B, seq_len, 1), in full
        float32 whatever the process's TF32 flags, which it leaves as it
        found them; in train mode with dropout ``rate`` after dec1 and dec2."""
        h = z[:, None, :].expand(-1, seq_len, -1).contiguous()
        with cudnn_fp32():
            h, _ = lstm_forward(self.dec1, h)
            h = dropout(h, rate, generator, self.training)
            h, _ = lstm_forward(self.dec2, h)
            h = dropout(h, rate, generator, self.training)
            h, _ = lstm_forward(self.dec3, h)
        # the 1 x 1 output layer as a multiply-add: no matmul, so no TF32
        return h * self.out.weight[:, 0] + self.out.bias

    def forward(self, x: torch.Tensor, rate: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.encode(x, rate, generator)
        return self.decode(z, x.shape[1], rate, generator)

    def latent_of(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)
