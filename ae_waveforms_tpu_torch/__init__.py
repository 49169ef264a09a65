"""ae_waveforms_tpu_torch — the PyTorch/CUDA port of ``ae_waveforms_tpu``.

The package mirrors the JAX package's sub-package and module names, so each
module's counterpart is found under the same path:

- ``serve``        batched scoring service (``Scorer``): reconstruction,
                   latents, RMSE, PRD and an optional GBT disorder head.
- ``models``       the LSTM autoencoder (its encoder on the fused kernel in
                   eval mode, on cuDNN in train mode) and the conv
                   autoencoder as ``nn.Module``s, their layers and registry.
- ``ops``          hand-written CUDA kernels for Hopper (``csrc/*.cu``), each
                   beside its plain PyTorch version: the fused LSTM encoder,
                   GBT histograms and GBT row routing; and the binding of
                   the float64 C++ delineator (``csrc/delineate.cpp``).
- ``classify``     the GBT classifier (fit and predict), LHS sampling and
                   the evaluation harness (grid search, size x seed sweep,
                   PPV analysis).
- ``traditional``  beats rebuilt from fiducials by Gaussian interpolation,
                   batched over beats and sigma maps, and the sigma search.
- ``analysis``     the traditional-vs-AE reconstruction comparison and the
                   plots (matplotlib, where installed).
- ``signals``      ECG filtering, windows, R peaks, QC, median beats,
                   delineation (float64 host and float32 device) and
                   features.
- ``data``         extraction from records to the three arrays (the
                   per-case cache, the streaming device engine), synthetic
                   records, the VitalDB loader.
- ``cli``          the extraction CLI, the AE CLI (``main_ae``: train,
                   test), the classify CLI (``latent``, ``features``,
                   ``ppv``) and the analysis CLI.
- ``core``         the extraction and training configs (``vars.env``
                   loaded at import), the array schema, the memory model
                   and the FLOP counts with the card's peaks.
- ``parallel``     several devices on ``torch.distributed``, one process a
                   device: the launcher, the (data, model) grid of ranks,
                   the tensor-parallel pair and the entry hooks.
- ``train``        AE training (``main_train``: the patient split, losses,
                   schedules, optimizers, logs) and the test pass with
                   latent export (``main_test``); checkpoints in the JAX
                   package's ``.npz`` leaf format.
- ``bridge``       weights carried between the two packages as numpy arrays.
- ``tools``        measurements on the card beyond ``chip_smoke.py`` (the
                   encoder, histogram and routing kernels' profiles).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain version.
Nothing is compiled at import: kernels are built with ``nvcc`` (the
delineator with ``g++``) on first use.
"""

from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "cudnn_fp32"]


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


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN (the LSTM decoder's RNNs, the conv autoencoder's convolutions)
    in full float32 inside, whatever the process's TF32 flags; every cuDNN
    flag as it was after.

    cuDNN's TF32 default keeps about three decimal digits, which would break
    the 1e-4 reconstruction tolerance the port is held to against the JAX
    package."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                 deterministic=c.deterministic, allow_tf32=False):
        yield
