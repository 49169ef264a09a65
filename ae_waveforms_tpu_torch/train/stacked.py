"""S models of one architecture trained at once, their parameters stacked
on a leading config axis (the port's counterpart of the JAX package's
``vmap`` over stacked parameter trees in ``train/multi.py`` and
``classify/dl.py``; shared by both trainers).

``torch.func.vmap`` cannot batch the recurrent layers: over
``functional_call`` of an ``nn.LSTM`` with stacked weights it fails with
"Batching rule not implemented for aten::lstm.input".  So each config runs
its own cuDNN calls, one config after another on the device's stream, with
its own slice of the stacked weights; what is stacked is what acts on
every config in one pass:

- every parameter and buffer (a BatchNorm's running statistics) is one
  tensor of shape (S, ...); config s's parameters are views of slice s,
  each a leaf of its own, so its gradient lands in its own ``.grad`` and an
  optimizer with one param group a config (``param_groups``) steps every
  config in one ``step()``, each at its own learning rate, with the update
  rule of the single-config trainer;
- best snapshots are (S, ...) copies, updated for the configs that
  improved by one ``torch.where`` a tensor (``take_``); the trainers'
  early-stop and plateau counters are (S,) arrays.

Each config's model is ``torch.func.functional_call`` of one template
module with that config's tensors, so the models' own code (dropout from
the caller's generator, ``cudnn_fp32``, the fused encoder kernel in eval
mode) runs unchanged; the models run their LSTMs through
``models.layers.lstm_forward``, which reads the swapped-in weights as they
are (``nn.LSTM.forward`` would copy them into a flat buffer of its own on
every call).  cuDNN reads an LSTM's four weights in place only where they
are one flat buffer in its order; the four slices of four stacked tensors
are not, and cuDNN would copy them and warn on every call.  So each call
copies them into one flat buffer first (``config_tensors``: one
``torch.cat`` an LSTM, differentiable, the bytes cuDNN's own copy would
move) and hands cuDNN views of it.

A config's result is the same as a single-config run of this code (S = 1):
its forward, backward and optimizer update are the same operations on the
same values.  A config that is done (early-stopped) is left out of the
forward and backward: its gradients stay None, which every optimizer of
``train/optimizers.py`` skips.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.func import functional_call

__all__ = ["StackedConfigs"]


class _Bound:
    """Config s of a ``StackedConfigs`` as a callable model: what
    ``train.loop.batch_loss`` and ``train.loop.validate`` call."""

    def __init__(self, stacked: "StackedConfigs", s: int):
        self.stacked, self.s = stacked, s

    def __call__(self, *args):
        return functional_call(self.stacked.template, self.stacked.config_tensors(self.s), args)

    def eval(self):
        self.stacked.template.eval()
        return self

    def train(self, mode: bool = True):
        self.stacked.template.train(mode)
        return self


class StackedConfigs:
    """The parameters and buffers of ``models`` (S modules of one
    architecture, e.g. built from S seeds) stacked on ``device``, run
    through ``template`` (a module of that architecture on ``device``)."""

    def __init__(self, template: nn.Module, models: Sequence[nn.Module], device):
        self.template = template
        self.S = len(models)
        self.device = torch.device(device)
        with torch.no_grad():
            self.params: Dict[str, torch.Tensor] = {
                name: torch.stack([dict(m.named_parameters())[name].detach().to(self.device) for m in models])
                for name, _ in template.named_parameters()
            }
            self.buffers: Dict[str, torch.Tensor] = {
                name: torch.stack([dict(m.named_buffers())[name].to(self.device) for m in models])
                for name, _ in template.named_buffers()
            }
        self.leaves: List[Dict[str, torch.Tensor]] = [
            {name: p[s].requires_grad_() for name, p in self.params.items()} for s in range(self.S)
        ]
        # each nn.LSTM's weights in cuDNN's flat order (w_ih, w_hh, b_ih, b_hh)
        self.lstm_groups = [
            [f"{prefix}.{w}" for w in module._flat_weights_names]
            for prefix, module in template.named_modules() if isinstance(module, nn.LSTM)
        ]

    def config_tensors(self, s: int) -> Dict[str, torch.Tensor]:
        """Config s's parameters and buffers under the template's names;
        each LSTM's weights as views of one flat copy (module docstring)."""
        leaves = self.leaves[s]
        out = dict(leaves)
        for names in self.lstm_groups:
            flat = torch.cat([leaves[n].reshape(-1) for n in names])
            for n, piece in zip(names, flat.split([leaves[n].numel() for n in names])):
                out[n] = piece.view(leaves[n].shape)
        out.update({name: b[s] for name, b in self.buffers.items()})
        return out

    def bound(self, s: int) -> _Bound:
        return _Bound(self, s)

    def param_groups(self, **defaults) -> List[dict]:
        """One optimizer param group a config, in config order."""
        return [dict(params=list(leaves.values()), **defaults) for leaves in self.leaves]

    def zero_grad(self) -> None:
        for leaves in self.leaves:
            for p in leaves.values():
                p.grad = None

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """A copy of every stacked parameter and buffer."""
        return {name: t.detach().clone() for name, t in {**self.params, **self.buffers}.items()}

    def take_(self, snap: Dict[str, torch.Tensor], mask: torch.Tensor) -> None:
        """``snap`` takes the current values of the configs where ``mask``
        (S,) is True."""
        current = {**self.params, **self.buffers}
        with torch.no_grad():
            for name, t in snap.items():
                m = mask.to(t.device).view((self.S,) + (1,) * (t.dim() - 1))
                t.copy_(torch.where(m, current[name], t))

    def load_(self, values: Dict[str, torch.Tensor]) -> None:
        """Overwrite the stacked parameters and buffers (a ``snapshot``)."""
        with torch.no_grad():
            for name, t in {**self.params, **self.buffers}.items():
                t.copy_(values[name])

    def module_of(self, s: int, values: Dict[str, torch.Tensor] = None) -> nn.Module:
        """The template holding config s's values (of ``values``, a
        ``snapshot``, or the current ones); the template's own tensors are
        overwritten, so read what is needed before the next call."""
        values = values if values is not None else {**self.params, **self.buffers}
        with torch.no_grad():
            for name, t in [*self.template.named_parameters(), *self.template.named_buffers()]:
                t.copy_(values[name][s])
        return self.template
