"""Carry weights between the JAX package and the port, as numpy arrays.

Both autoencoders' JAX parameter dicts already use torch's layouts, so the
mapping is by name and bit-exact both ways: the LSTM autoencoder's
``enc1``..``dec3`` with ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` and ``out``
with ``w``, ``b``; the conv autoencoder's ``e1``..``e4``, ``e_lat``,
``d_lat``, ``d1``..``d4``, each with ``w`` ((out, in, K) for a conv, (in,
out, K) for a transposed conv) and ``b``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier, GBTEnsemble
from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder

__all__ = ["lstm_ae_params_from_numpy", "lstm_ae_params_to_numpy", "conv_ae_params_from_numpy",
           "conv_ae_params_to_numpy", "gbt_from_numpy"]


def lstm_ae_params_from_numpy(tree: Dict, device=None) -> LSTMAutoencoder:
    """An ``LSTMAutoencoder`` holding the JAX parameter dict's weights, on
    ``device`` (the first CUDA device unless named), in eval mode (its
    encoder on the fused kernel, as ``Scorer`` runs it); the widths are
    read from the arrays' shapes."""
    h1 = np.shape(tree["enc1"]["w_hh"])[1]
    h2 = np.shape(tree["enc2"]["w_hh"])[1]
    latent = np.shape(tree["enc3"]["w_hh"])[1]
    model = LSTMAutoencoder(latent, (h1, h2), device=resolve_device(device))
    model.load_jax_tree(tree)
    return model.eval()


def _params_to_numpy(model) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        name: {k: p.detach().cpu().numpy().copy() for k, p in params.items()}
        for name, params in model.jax_tree().items()
    }


def lstm_ae_params_to_numpy(model: LSTMAutoencoder) -> Dict[str, Dict[str, np.ndarray]]:
    """The module's weights as the JAX parameter dict of numpy arrays."""
    return _params_to_numpy(model)


def conv_ae_params_from_numpy(tree: Dict, device=None) -> LeNet5AutoencoderAvgPool:
    """A ``LeNet5AutoencoderAvgPool`` holding the JAX parameter dict's
    weights, on ``device`` (the first CUDA device unless named), in eval
    mode; the latent width is read from ``e_lat``'s weight."""
    model = LeNet5AutoencoderAvgPool(np.shape(tree["e_lat"]["w"])[0], device=resolve_device(device))
    model.load_jax_tree(tree)
    return model.eval()


def conv_ae_params_to_numpy(model: LeNet5AutoencoderAvgPool) -> Dict[str, Dict[str, np.ndarray]]:
    """The module's weights as the JAX parameter dict of numpy arrays."""
    return _params_to_numpy(model)


def gbt_from_numpy(feat, thresh, is_split, leaf, lr, edges, params: Dict, device=None) -> GBTClassifier:
    """A port ``GBTClassifier`` from a JAX-fitted one: its ensemble arrays
    (``_ens`` fields), bin edges (``_edges``) and ``get_params()``."""
    ens = GBTEnsemble(
        feat=np.array(feat, np.int32),
        thresh=np.array(thresh, np.int32),
        is_split=np.array(is_split, bool),
        leaf=np.array(leaf, np.float32),
        lr=np.array(lr, np.float32),
    )
    return GBTClassifier(**params, device=device).load_ensemble(ens, np.array(edges, np.float32))
