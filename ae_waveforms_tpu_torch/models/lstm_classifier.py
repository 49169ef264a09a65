"""End-to-end LSTM classifier as an ``nn.Module`` (the port of the JAX
package's ``models/lstm_classifier.py``; capability twin of
functions_dl/model_classes.py:8-32).

LSTM 1->128->64->64 with dropout between the LSTMs, softmax attention
pooling over time, BatchNorm over the pooled features, FC 64->32 (ReLU),
FC 32->1, sigmoid.  BatchNorm follows torch: in train mode the batch's
biased statistics normalise and the running statistics move by momentum
0.1 towards the batch mean and the unbiased variance; in eval mode the
running statistics normalise; eps 1e-5.

The LSTMs run as cuDNN LSTMs inside ``cudnn_fp32``; the trainer runs the
backward inside it too (``classify/dl.py``).  The dense layers are
products and sums, not matmuls, so they keep full float32 whatever the
process's TF32 flags.  Dropout draws from the ``generator`` the caller
passes.  ``remat_chunk`` recomputes each LSTM in chunks of that many time
steps in the backward (``torch.utils.checkpoint``, the (h, c) carried
across chunks): the same gradients, and only the chunk boundaries' carries
and one chunk's cuDNN reserve space held in place of the whole sequence's.

``jax_tree`` and ``state_tree`` name the parameters and the BatchNorm
state as the JAX package does (``lstm1``..``lstm3``, ``attn``, ``fc1``,
``fc2``, ``bn_gamma``, ``bn_beta``; ``bn_mean``, ``bn_var``), which is how
checkpoints and the bridge carry them across.  Input layout (B, T, 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.models.layers import copy_tree_, dropout, linear_init, lstm_forward, lstm_init

__all__ = ["LSTMClassifier"]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
_LSTM_NAMES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b as a product and a sum: no matmul, so no TF32."""
    return (x.unsqueeze(-2) * w).sum(-1) + b


def _lstm_chunk(x, h, c, *weights):
    out, h, c = torch.lstm(x, (h, c), weights, True, 1, 0.0, True, False, True)
    return out, h, c


def _lstm_remat(lstm: nn.LSTM, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``lstm(x)``'s outputs, each chunk of time steps checkpointed.  The
    weights are read from the module's attributes once and passed to the
    checkpointed function, not read again in the backward: under
    ``functional_call`` the module holds them only during the forward."""
    weights = [getattr(lstm, name) for name in lstm._flat_weights_names]
    h = c = x.new_zeros((1, x.shape[0], lstm.hidden_size))
    outs = []
    for t0 in range(0, x.shape[1], chunk):
        out, h, c = checkpoint(_lstm_chunk, x[:, t0:t0 + chunk], h, c, *weights, use_reentrant=False)
        outs.append(out)
    return torch.cat(outs, dim=1)


class LSTMClassifier(nn.Module):
    def __init__(self, hidden_sizes: Tuple[int, int] = (128, 64), generator: Optional[torch.Generator] = None,
                 device=None):
        """Weights drawn from ``generator`` (seed 0 when None) with torch's
        uniform inits, layer by layer in the order lstm1..3, attn, fc1,
        fc2; BatchNorm gamma 1, beta 0, running mean 0 and variance 1.  The
        module lives on ``device``: the first CUDA device unless named."""
        super().__init__()
        h1, h2 = hidden_sizes
        self.sizes = {"lstm1": (1, h1), "lstm2": (h1, h2), "lstm3": (h2, h2)}
        for name, (i, h) in self.sizes.items():
            setattr(self, name, nn.LSTM(i, h, batch_first=True, device="meta"))
        self.attn = nn.Linear(h2, 1, device="meta")
        self.fc1 = nn.Linear(h2, 32, device="meta")
        self.fc2 = nn.Linear(32, 1, device="meta")
        self.bn_gamma = nn.Parameter(torch.empty(h2, device="meta"))
        self.bn_beta = nn.Parameter(torch.empty(h2, device="meta"))
        self.register_buffer("bn_mean", torch.empty(h2, device="meta"))
        self.register_buffer("bn_var", torch.empty(h2, device="meta"))
        self.to_empty(device=resolve_device(device))
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        tree = {name: lstm_init(g, i, h) for name, (i, h) in self.sizes.items()}
        tree.update(attn=linear_init(g, h2, 1), fc1=linear_init(g, h2, 32), fc2=linear_init(g, 32, 1),
                    bn_gamma=torch.ones(h2), bn_beta=torch.zeros(h2))
        self.load_jax_tree(tree, {"bn_mean": torch.zeros(h2), "bn_var": torch.ones(h2)})

    def jax_tree(self) -> Dict:
        """The parameters under the JAX package's names (no copies)."""
        tree = {name: {k: getattr(getattr(self, name), v) for k, v in _LSTM_NAMES.items()} for name in self.sizes}
        tree.update({name: {"w": getattr(self, name).weight, "b": getattr(self, name).bias}
                     for name in ("attn", "fc1", "fc2")})
        tree.update(bn_gamma=self.bn_gamma, bn_beta=self.bn_beta)
        return tree

    def state_tree(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm state under the JAX package's names (no copies)."""
        return {"bn_mean": self.bn_mean, "bn_var": self.bn_var}

    def load_jax_tree(self, tree, state=None) -> None:
        """Copy a JAX-named parameter tree, and BatchNorm ``state`` where
        given (arrays or tensors), in."""
        own = self.jax_tree()
        copy_tree_({k: v for k, v in own.items() if isinstance(v, dict)}, tree)
        flat = {"bn_gamma": self.bn_gamma, "bn_beta": self.bn_beta}
        if state is not None:
            flat.update(self.state_tree())
            tree = {**tree, **state}
        copy_tree_({"_": flat}, {"_": tree})

    def forward(self, x: torch.Tensor, rate: float = 0.0, generator: Optional[torch.Generator] = None,
                remat_chunk: Optional[int] = None) -> torch.Tensor:
        """x (B, T, 1) -> probabilities (B, 1).  In train mode: dropout
        ``rate`` after lstm1 and lstm2, BatchNorm on the batch's statistics
        and the running statistics updated in place."""
        h = x
        with cudnn_fp32():
            for name in self.sizes:
                if name != "lstm1":
                    h = dropout(h, rate, generator, self.training)
                lstm = getattr(self, name)
                h = _lstm_remat(lstm, h, remat_chunk) if remat_chunk else lstm_forward(lstm, h)[0]
        attn = torch.softmax(_dense(h, self.attn.weight, self.attn.bias), dim=1)  # (B, T, 1)
        pooled = (h * attn).sum(dim=1)  # (B, H)
        if self.training:
            mu = pooled.mean(dim=0)
            var = ((pooled - mu) ** 2).mean(dim=0)
            n = pooled.shape[0]
            with torch.no_grad():
                self.bn_mean.copy_((1 - _BN_MOMENTUM) * self.bn_mean + _BN_MOMENTUM * mu)
                self.bn_var.copy_((1 - _BN_MOMENTUM) * self.bn_var + _BN_MOMENTUM * (var * n / max(n - 1, 1)))
        else:
            mu, var = self.bn_mean, self.bn_var
        normed = (pooled - mu) / torch.sqrt(var + _BN_EPS) * self.bn_gamma + self.bn_beta
        h = torch.relu(_dense(normed, self.fc1.weight, self.fc1.bias))
        return torch.sigmoid(_dense(h, self.fc2.weight, self.fc2.bias))
