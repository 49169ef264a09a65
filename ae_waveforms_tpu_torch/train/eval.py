"""Trained-weight loading and the test pass with latent export (the port of
the JAX package's ``train/eval.py``; capability twin of
functions_ae/run_test.py:18-129).

``main_test`` loads the best (or final) checkpoint, runs the test split in
padded batches of ``cfg.batch_size`` with the model in eval mode under
``no_grad``, computes each batch's latent once (the LSTM autoencoder's
through the fused encoder kernel on the card) and decodes that latent.  It writes
``np_waves_test_pred.npy`` (n, 320) and ``np_latent_spaces.npy`` (n,
latent) and prints the global loss, per-sample RMSE and PRD; with
``cfg.plotting`` it draws the RMSE distribution where matplotlib is
installed, and logs a warning where it is not.
"""

from __future__ import annotations

import glob
import importlib.util
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, load_arrays
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train import checkpoint as ckpt
from ae_waveforms_tpu_torch.train.data import layout_waves
from ae_waveforms_tpu_torch.train.loop import _batched_indices, _elementwise_loss, _finalize_loss
from ae_waveforms_tpu_torch.train.losses import sample_prd_loss, sample_rmse_loss

__all__ = ["main_test", "load_trained_params"]


def load_trained_params(model_dir: str, cfg: TrainConfig, device=None) -> nn.Module:
    """Rebuild the architecture on ``device`` (the first CUDA device unless
    named) and load its weights, preferring the rolling best checkpoint
    (load_model.py:35-84 semantics).  Returns the module in eval mode."""
    device = resolve_device(device)
    model = model_def(cfg.model_class).build(cfg.latent_size, device=device)
    model.load_jax_tree(ckpt.load_state(ckpt.latest_best(model_dir), model.jax_tree()))
    return model.eval()


def main_test(
    cfg: TrainConfig,
    arrays: Optional[ArraySet] = None,
    params: Optional[Dict] = None,
    device=None,
) -> Tuple[str, tuple, tuple, np.ndarray]:
    """The test pass of run ``cfg.trained_model`` on ``device``; ``params``
    (the JAX package's numpy tree) in place of the run's checkpoint.
    Returns (predictions file, (loss, rmse, rmse per sample, prd, prd per
    sample), (predictions, beats, info rows), latents)."""
    mdef = model_def(cfg.model_class)
    device = resolve_device(device)

    results_dir = os.path.join(cfg.results_dir, "test_autoencoder", cfg.trained_model)
    os.makedirs(results_dir, exist_ok=True)
    results_file = os.path.join(results_dir, "np_waves_test_pred.npy")

    model_dir = os.path.join(cfg.results_dir, "networks_autoencoder", cfg.trained_model)
    if params is None:
        model = load_trained_params(model_dir, cfg, device)
    else:
        model = mdef.build(cfg.latent_size, device=device)
        model.load_jax_tree(params)
        model.eval()

    if arrays is None:
        arrays = load_arrays(cfg.dataset_dir)
    test_files = sorted(glob.glob(os.path.join(model_dir, "indices_test_*.npy")))
    if not test_files:
        raise FileNotFoundError(f"no test-index mask in {model_dir}")
    te_mask = np.load(test_files[0])
    if int(te_mask.sum()) == 0:
        raise ValueError(
            f"test-index mask in {model_dir} selects 0 samples: the seeded "
            "patient-level draw left the test split empty — re-split with a "
            "different seed, more cases, or a larger split_size_test"
        )

    waves = np.asarray(arrays.waves, np.float32)[te_mask]
    n, beat_len = waves.shape
    x_np = layout_waves(waves, mdef.channel_first)
    idx, _ = _batched_indices(n, cfg.batch_size, np.arange(n, dtype=np.int32))
    x_dev = torch.from_numpy(np.ascontiguousarray(x_np)).to(device)
    preds, zs = [], []
    with torch.no_grad():
        for bidx in torch.from_numpy(idx).to(device):
            x = x_dev.index_select(0, bidx)
            z = model.encode(x)
            preds.append(model.decode(z, beat_len))
            zs.append(z)
    pred_flat = torch.cat(preds)[:n].reshape(n, -1).cpu().numpy()
    zs = torch.cat(zs)[:n].reshape(n, -1).cpu().numpy()
    np.save(results_file, pred_flat)
    np.save(os.path.join(results_dir, "np_latent_spaces.npy"), zs)

    true_flat = x_np.reshape(n, -1)
    pred_t, true_t = torch.from_numpy(pred_flat), torch.from_numpy(np.ascontiguousarray(true_flat))
    elem = _elementwise_loss(cfg.loss, pred_t, true_t)
    test_loss = float(_finalize_loss(cfg.loss, elem.sum(), elem.numel()))
    rmse_avg, rmse_per = sample_rmse_loss(pred_t, true_t)
    prd_avg, prd_per = sample_prd_loss(pred_t, true_t)
    rmse_avg, prd_avg = float(rmse_avg), float(prd_avg)
    rmse_per, prd_per = rmse_per.numpy(), prd_per.numpy()

    print(f"Global test {cfg.loss.upper()} loss: {test_loss:.6f}")
    print(f"Sample wise average test RMSE loss: {rmse_avg:.6f}")
    print(f"Sample wise average test PRD loss: {prd_avg:.6f}")

    if cfg.plotting:
        if importlib.util.find_spec("matplotlib") is None:
            logging.getLogger("test").warning("plotting: matplotlib is not installed; no RMSE plot written")
        else:
            from ae_waveforms_tpu_torch.analysis.plots import plot_rmse_distribution

            plot_rmse_distribution(rmse_avg, rmse_per, results_dir)

    return (
        results_file,
        (test_loss, rmse_avg, rmse_per, prd_avg, prd_per),
        (pred_flat, true_flat, np.asarray(arrays.info)[te_mask]),
        zs,
    )
