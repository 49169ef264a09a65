"""Loss and quality metrics on tensors (the port of the JAX package's
``train/losses.py``; reference: loss_functions.py:4-20 plus the SmoothL1/MSE
selection in run_train.py:205-212).

Per-sample variants return (mean, per_sample) like the reference's tuple
contract.
"""

from __future__ import annotations

import torch

__all__ = ["mse_loss", "rmse_loss", "smooth_l1_loss", "sample_rmse_loss", "sample_prd_loss", "LOSSES"]


def mse_loss(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - true) ** 2)


def rmse_loss(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred - true) ** 2))


def smooth_l1_loss(pred: torch.Tensor, true: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss (the reference's 'mae' option)."""
    d = torch.abs(pred - true)
    return torch.mean(torch.where(d < beta, 0.5 * d**2 / beta, d - 0.5 * beta))


def sample_rmse_loss(pred: torch.Tensor, true: torch.Tensor):
    per = torch.sqrt(torch.mean((pred - true) ** 2, dim=1))
    return torch.mean(per), per


def sample_prd_loss(pred: torch.Tensor, true: torch.Tensor):
    """Percentage RMS difference per sample: 100 * sqrt(sum err^2 / sum true^2)."""
    num = torch.sum((true - pred) ** 2, dim=1)
    den = torch.sum(true**2, dim=1)
    per = 100.0 * torch.sqrt(num / den)
    return torch.mean(per), per


LOSSES = {"mse": mse_loss, "rmse": rmse_loss, "mae": smooth_l1_loss}
