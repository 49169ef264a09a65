"""AE training and the test pass: losses, schedules, optimizers, splits,
checkpoints and logs.  ``Ranger`` is the ``torch.optim.Optimizer`` in place
of the JAX package's optax transform ``ranger``."""

from ae_waveforms_tpu_torch.train.losses import mse_loss, rmse_loss, sample_prd_loss, sample_rmse_loss, smooth_l1_loss
from ae_waveforms_tpu_torch.train.ranger import Ranger
from ae_waveforms_tpu_torch.train.schedules import (
    cosine_annealing_warm_restarts,
    cosine_annealing_warmup_hard_restarts,
    step_lr,
)

__all__ = [
    "mse_loss",
    "rmse_loss",
    "smooth_l1_loss",
    "sample_rmse_loss",
    "sample_prd_loss",
    "Ranger",
    "step_lr",
    "cosine_annealing_warm_restarts",
    "cosine_annealing_warmup_hard_restarts",
]
