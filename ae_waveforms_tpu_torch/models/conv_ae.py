"""Convolutional autoencoder as an ``nn.Module`` (the port of the JAX
package's ``models/conv_ae.py``; capability twin of model_classes.py:51-108).

Encoder: 4 x [stride-2 conv k3 p1 + ReLU + avg-pool 2] taking (B, 1, 320)
-> (B, 128, 1), then a 1x1 conv to (B, latent, 1).  Decoder: 1x1 deconv to
128 channels, then alternating linear upsamples to sizes 3/10/40/160 and
stride-2 deconvs (k3, p1, output_padding 1), ending at (B, 1, 320).
Dropout after encoder block 2's ReLU (before its pool) and decoder block
2's ReLU, in train mode only, drawn from the ``generator`` the caller
passes.

Every convolution runs inside ``cudnn_fp32``: cuDNN's TF32 default would
keep about three decimal digits, which the 1e-5 forward tolerance against
the JAX package cannot take.  The trainer runs the backward pass inside it
too (``train.loop.train_step``).

Input layout (B, 1, T) ("conv layout").  The upsample sizes pin every
length, so the decoder's output is always 320 samples long.  ``jax_tree``
names the parameters as the JAX package does (``e1``..``e4``, ``e_lat``,
``d_lat``, ``d1``..``d4``, each with ``w`` and ``b``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.models.layers import (
    avg_pool1d,
    conv1d_apply,
    conv1d_init,
    conv1d_transpose_apply,
    copy_tree_,
    dropout,
    upsample_linear,
)

__all__ = ["LeNet5AutoencoderAvgPool"]

OUT_LENGTH = 320
_ENCODER = (("e1", 1, 16), ("e2", 16, 32), ("e3", 32, 64), ("e4", 64, 128))
_DECODER = (("d1", 128, 64), ("d2", 64, 32), ("d3", 32, 16), ("d4", 16, 1))
_UPSAMPLE = (3, 10, 40, 160)  # the length before d1, d2, d3, d4


class LeNet5AutoencoderAvgPool(nn.Module):
    def __init__(self, latent_size: int = 10, generator: Optional[torch.Generator] = None, device=None):
        """Weights are drawn from ``generator`` (seed 0 when None) in the
        JAX package's key order e1..e4, e_lat, d_lat, d1..d4, each ``w``
        then ``b``.  The module lives on ``device``: the first CUDA device
        unless named (``resolve_device``)."""
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        tree = {name: conv1d_init(g, i, o, 3) for name, i, o in _ENCODER}
        tree["e_lat"] = conv1d_init(g, 128, latent_size, 1)
        tree["d_lat"] = conv1d_init(g, latent_size, 128, 1, transpose=True)
        tree.update({name: conv1d_init(g, i, o, 3, transpose=True) for name, i, o in _DECODER})
        device = resolve_device(device)
        for name, params in tree.items():
            setattr(self, name, nn.ParameterDict({k: nn.Parameter(v.to(device)) for k, v in params.items()}))
        self.names = tuple(tree)

    def jax_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters under the JAX package's names (no copies)."""
        return {name: {"w": getattr(self, name)["w"], "b": getattr(self, name)["b"]} for name in self.names}

    def load_jax_tree(self, tree) -> None:
        """Copy a JAX-named parameter tree (arrays or tensors) in."""
        copy_tree_(self.jax_tree(), tree)

    def encode(self, x: torch.Tensor, rate: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, 1, T) -> latent (B, latent, 1); in train mode with dropout
        ``rate`` after e2's ReLU."""
        tree = self.jax_tree()
        h = x
        with cudnn_fp32():
            for name, _, _ in _ENCODER:
                h = torch.relu(conv1d_apply(tree[name], h, stride=2, padding=1))
                if name == "e2":
                    h = dropout(h, rate, generator, self.training)
                h = avg_pool1d(h)
            return conv1d_apply(tree["e_lat"], h)

    def decode(self, z: torch.Tensor, seq_len: int = OUT_LENGTH, rate: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """latent (B, latent, 1) -> reconstruction (B, 1, 320); in train
        mode with dropout ``rate`` after d2's ReLU.  ``seq_len`` is the beat
        length the caller expects, which the upsample sizes pin to 320."""
        if seq_len != OUT_LENGTH:
            raise ValueError(f"the conv decoder's output is {OUT_LENGTH} samples long, not {seq_len}")
        tree = self.jax_tree()
        with cudnn_fp32():
            h = torch.relu(conv1d_transpose_apply(tree["d_lat"], z, stride=1, padding=0, output_padding=0))
            for (name, _, _), size in zip(_DECODER, _UPSAMPLE):
                h = conv1d_transpose_apply(tree[name], upsample_linear(h, size))
                if name != "d4":
                    h = torch.relu(h)
                if name == "d2":
                    h = dropout(h, rate, generator, self.training)
        return h

    def forward(self, x: torch.Tensor, rate: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x, rate, generator), x.shape[-1], rate, generator)

    def latent_of(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)
