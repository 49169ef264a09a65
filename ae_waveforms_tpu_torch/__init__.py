"""ae_waveforms_tpu_torch — the PyTorch/CUDA port of ``ae_waveforms_tpu``.

The package mirrors the JAX package's sub-package and module names, so each
module's counterpart is found under the same path:

- ``serve``        batched scoring service (``Scorer``): reconstruction,
                   latents, RMSE, PRD and an optional GBT disorder head.
- ``models``       the LSTM autoencoder as an ``nn.Module`` and its registry.
- ``ops``          hand-written CUDA kernels for Hopper (``csrc/*.cu``), each
                   beside its plain PyTorch version: the fused LSTM encoder,
                   GBT histograms and GBT row routing.
- ``classify``     the GBT classifier (fit and predict), LHS sampling and
                   the evaluation harness (grid search, size x seed sweep,
                   PPV analysis).
- ``cli``          the classify CLI (``latent``, ``features``, ``ppv``).
- ``core``         the training config and the array schema.
- ``train``        checkpoints in the JAX package's ``.npz`` leaf format,
                   trained-weight loading and the wave layout helper.
- ``bridge``       weights carried between the two packages as numpy arrays.
- ``tools``        measurements on the card beyond ``chip_smoke.py`` (the
                   encoder and histogram kernels' profiles).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain version.
Nothing is compiled at import: kernels are built with ``nvcc`` on first use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "full_fp32"]


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` when ``device`` is None, else ``torch.device(device)``.

    Raises when no CUDA device is present and none was named: the CPU runs
    only when the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda:0")


def full_fp32() -> None:
    """Keep float32 matmuls and cuDNN (the decoder's LSTMs) out of TF32.

    cuDNN's TF32 default keeps about three decimal digits, which would break
    the 2e-5 latent tolerance the port is held to against the JAX package."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
