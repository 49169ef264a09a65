"""Trained-weight loading (the port's slice of the JAX package's
``train/eval.py``; the test pass comes with the training slice)."""

from __future__ import annotations

from torch import nn

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train import checkpoint as ckpt

__all__ = ["load_trained_params"]


def load_trained_params(model_dir: str, cfg: TrainConfig, device=None) -> nn.Module:
    """Rebuild the architecture on ``device`` (the first CUDA device unless
    named) and load its weights, preferring the rolling best checkpoint
    (load_model.py:35-84 semantics).  Returns the module in eval mode."""
    device = resolve_device(device)
    model = model_def(cfg.model_class).build(cfg.latent_size, device=device)
    model.load_jax_tree(ckpt.load_state(ckpt.latest_best(model_dir), model.jax_tree()))
    return model.eval()
