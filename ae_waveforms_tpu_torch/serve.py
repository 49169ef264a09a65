"""Batched scoring service — the deployment-facing path.

Takes raw median beats and produces AE reconstructions, latents, per-sample
quality metrics (RMSE/PRD) and, when a classifier head is attached, disorder
probabilities.  Everything stays on the device between stages; the host
only moves the input batch in and the scores out.

    scorer = Scorer.from_run(results_dir, run_name, cfg)       # AE only
    scorer.attach_gbt(gbt_classifier)                          # + head
    out = scorer.score(waves)                                  # (B, 320)

The latent is computed once (for the LSTM autoencoder by the fused encoder
kernel) and decoded from there; latents come out as (B, d) for either
model.  The GBT head routes all its trees at once through the routing
kernel.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train.data import layout_waves

__all__ = ["Scorer"]


class Scorer:
    def __init__(self, model: nn.Module, model_class: str, gbt=None, device=None):
        """The model's parameters move to ``device`` (the first CUDA device
        unless named) at construction, so requests never re-upload them."""
        self.device = resolve_device(device)
        self.model_class = model_class
        self.channel_first = model_def(model_class).channel_first
        self.model = model.to(self.device).eval()
        self.gbt = None
        if gbt is not None:
            self.attach_gbt(gbt)

    @classmethod
    def from_run(cls, results_dir: str, run_name: str, cfg: TrainConfig, device=None) -> "Scorer":
        from ae_waveforms_tpu_torch.train.eval import load_trained_params

        model_dir = os.path.join(results_dir, "networks_autoencoder", run_name)
        model = load_trained_params(model_dir, cfg, device)
        return cls(model=model, model_class=cfg.model_class, device=device)

    def attach_gbt(self, classifier) -> "Scorer":
        self.gbt = classifier.to(self.device)
        return self

    def warmup(self, bucket: int = 64) -> float:
        """Score one padded bucket before the first request (building the
        kernels on first use); returns the wall seconds spent — the
        cold-start cost a deployment pays once."""
        t0 = time.perf_counter()
        self.score(np.zeros((1, 320), np.float32), bucket=bucket)
        return time.perf_counter() - t0

    @torch.inference_mode()
    def score(self, waves: np.ndarray, bucket: int = 64) -> Dict[str, np.ndarray]:
        """waves: (B, 320) raw median beats -> dict with reconstruction,
        latents, rmse, prd and (if attached) probability, as numpy arrays.

        Batches are padded to ``bucket`` multiples, as the JAX service pads
        them, so both run the same shapes."""
        waves = np.asarray(waves, np.float32)
        n = len(waves)
        target = max(bucket, ((n + bucket - 1) // bucket) * bucket)
        if target != n:
            waves = np.concatenate([waves, np.zeros((target - n, waves.shape[1]), np.float32)])
        x = torch.from_numpy(np.ascontiguousarray(layout_waves(waves, self.channel_first))).to(self.device)
        z = self.model.encode(x)
        pred = self.model.decode(z, waves.shape[1])
        if z.ndim == 3:  # the conv autoencoder's (B, d, 1)
            z = z[:, :, 0]
        flat_p = pred.reshape(pred.shape[0], -1)
        flat_x = x.reshape(x.shape[0], -1)
        rmse = torch.sqrt(torch.mean((flat_p - flat_x) ** 2, dim=1))
        prd = 100.0 * torch.sqrt(torch.sum((flat_x - flat_p) ** 2, dim=1) / torch.sum(flat_x**2, dim=1))
        out = {
            "reconstruction": flat_p[:n].cpu().numpy(),
            "latents": z[:n].cpu().numpy(),
            "rmse": rmse[:n].cpu().numpy(),
            "prd": prd[:n].cpu().numpy(),
        }
        if self.gbt is not None:
            out["probability"] = self.gbt.predict_proba(z[:n])[:, 1]
        return out
