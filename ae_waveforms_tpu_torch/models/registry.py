"""Model registry (reference: model_classes.py:113-116 dict of classes).

Each entry gives the module class and the input layout flag the data
pipeline needs: conv models take (B, 1, 320) ("channel-first"), recurrent
models take (B, 320, 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder

__all__ = ["MODEL_REGISTRY", "ModelDef", "model_def", "build_model", "input_layout"]


@dataclass(frozen=True)
class ModelDef:
    name: str
    build: Callable[..., nn.Module]  # (latent_size, generator=None, device=None)
    channel_first: bool  # True -> (B, 1, L); False -> (B, L, 1)


MODEL_REGISTRY: Dict[str, ModelDef] = {
    "LSTMAutoencoder": ModelDef(name="LSTMAutoencoder", build=LSTMAutoencoder, channel_first=False),
    "LeNet5AutoencoderAvgPool": ModelDef(name="LeNet5AutoencoderAvgPool", build=LeNet5AutoencoderAvgPool,
                                         channel_first=True),
}


def model_def(name: str) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model class {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def build_model(name: str, generator: Optional[torch.Generator] = None, latent_size: int = 10,
                dropout: float = 0.2, device=None) -> Tuple[ModelDef, nn.Module]:
    """``(ModelDef, module)`` of model class ``name``, its weights drawn from
    ``generator`` (seed 0 when None), on ``device`` (the first CUDA device
    unless named).

    ``dropout`` sets nothing, as in the JAX package's ``init``: neither
    module holds a rate.  The rate is a forward-time argument
    (``forward(x, rate, generator)``, ``encode`` and ``decode`` alike), which
    the trainer passes as ``cfg.dropout`` in train mode."""
    del dropout
    mdef = model_def(name)
    return mdef, mdef.build(latent_size, generator=generator, device=device)


def input_layout(name: str) -> bool:
    """True if the model consumes (B, 1, L) channel-first input."""
    return MODEL_REGISTRY[name].channel_first
