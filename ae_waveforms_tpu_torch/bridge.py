"""Carry weights between the JAX package and the port, as numpy arrays.

Both autoencoders' JAX parameter dicts already use torch's layouts, so the
mapping is by name and bit-exact both ways: the LSTM autoencoder's
``enc1``..``dec3`` with ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` and ``out``
with ``w``, ``b``; the conv autoencoder's ``e1``..``e4``, ``e_lat``,
``d_lat``, ``d1``..``d4``, each with ``w`` ((out, in, K) for a conv, (in,
out, K) for a transposed conv) and ``b``; the LSTM classifier's ``lstm1``..
``lstm3``, ``attn``, ``fc1``, ``fc2``, ``bn_gamma``, ``bn_beta`` and its
BatchNorm state ``bn_mean``, ``bn_var``; the MLP head's list of layers,
each ``w`` (in, out) and ``b``.  A multi-config tree is any of these with a
leading config axis on every leaf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier, GBTEnsemble
from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder

__all__ = ["lstm_ae_params_from_numpy", "lstm_ae_params_to_numpy", "conv_ae_params_from_numpy",
           "conv_ae_params_to_numpy", "gbt_from_numpy", "classifier_from_numpy", "classifier_to_numpy",
           "tree_from_numpy", "tree_to_numpy"]


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


def classifier_from_numpy(params: Dict, state: Dict, device=None) -> LSTMClassifier:
    """An ``LSTMClassifier`` holding the JAX parameter dict's weights and
    BatchNorm state, on ``device`` (the first CUDA device unless named), in
    eval mode; the widths are read from the arrays' shapes."""
    hidden = (np.shape(params["lstm1"]["w_hh"])[1], np.shape(params["lstm2"]["w_hh"])[1])
    model = LSTMClassifier(hidden, device=resolve_device(device))
    model.load_jax_tree(params, state)
    return model.eval()


def classifier_to_numpy(model: LSTMClassifier) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """The module's (params, BatchNorm state) as the JAX dicts of numpy
    arrays."""
    return tree_to_numpy(model.jax_tree()), tree_to_numpy(model.state_tree())


def tree_from_numpy(tree, device=None):
    """A tree of arrays (dicts and lists: the MLP head's params, or any tree
    with a leading config axis on its leaves) as the same tree of tensors on
    ``device`` (the first CUDA device unless named)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def tree_to_numpy(tree):
    """A tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().copy()
