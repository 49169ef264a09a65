"""The two autoencoders of the reference (``LSTMAutoencoder`` and
``LeNet5AutoencoderAvgPool``, model_classes.py), their mse loss, dropout
and Adam in optax's order, written out in plain torch operations.

Parameters use the JAX package's names (``enc1.w_ih`` ...; ``e1.w`` ...)
in torch's layouts.  The dtype is the caller's: float64 for the
reference, float32 with TF32 on for the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Tree = Dict[str, Dict[str, torch.Tensor]]


def lstm_layer(p: Dict[str, torch.Tensor], x: torch.Tensor):
    """One LSTM layer, gates (i, f, g, o), zero initial state: (outputs, last h)."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[1]
    gx = x @ p["w_ih"].T + (p["b_ih"] + p["b_hh"])
    w_hh_t = p["w_hh"].T
    h = c = x.new_zeros((B, H))
    outs = []
    for t in range(T):
        i, f, g, o = (gx[:, t] + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def _drop(h: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return h if keep is None else torch.where(keep, h / (1.0 - rate), 0.0)


def lstm_ae(params: Tree, x: torch.Tensor, keeps: Optional[List[torch.Tensor]] = None, rate: float = 0.0,
            alter=None):
    """x (B, T, 1) -> (reconstruction (B, T, 1), latent (B, L)); ``keeps``:
    the dropout masks after enc1, enc2, dec1 and dec2, or None; ``alter``:
    a function the latent passes through before the decoder (a planted
    fault), or None."""
    k = keeps or [None] * 4
    h, _ = lstm_layer(params["enc1"], x)
    h, _ = lstm_layer(params["enc2"], _drop(h, k[0], rate))
    _, z = lstm_layer(params["enc3"], _drop(h, k[1], rate))
    z = z if alter is None else alter(z)
    h, _ = lstm_layer(params["dec1"], z[:, None, :].expand(-1, x.shape[1], -1))
    h, _ = lstm_layer(params["dec2"], _drop(h, k[2], rate))
    h, _ = lstm_layer(params["dec3"], _drop(h, k[3], rate))
    return h * params["out"]["w"][:, 0] + params["out"]["b"], z


CONV_ENCODER = ("e1", "e2", "e3", "e4")
CONV_DECODER = (("d1", 3), ("d2", 10), ("d3", 40), ("d4", 160))  # layer, the length it is upsampled to first


def conv_ae(params: Tree, x: torch.Tensor, keeps: Optional[List[torch.Tensor]] = None, rate: float = 0.0,
            alter=None):
    """x (B, 1, 320) -> (reconstruction (B, 1, 320), latent (B, L, 1)):
    four stride-2 convolutions with ReLU and average pooling, a 1 x 1
    convolution to the latent; a 1 x 1 transposed convolution back,
    then linear (half-pixel) upsampling and stride-2 transposed
    convolutions; dropout after e2's and d2's ReLU; ``alter`` as for
    ``lstm_ae``."""
    k = keeps or [None] * 2
    h = x
    for name in CONV_ENCODER:
        h = torch.relu(F.conv1d(h, params[name]["w"], params[name]["b"], stride=2, padding=1))
        if name == "e2":
            h = _drop(h, k[0], rate)
        h = F.avg_pool1d(h, 2, 2)
    z = F.conv1d(h, params["e_lat"]["w"], params["e_lat"]["b"])
    z = z if alter is None else alter(z)
    h = torch.relu(F.conv_transpose1d(z, params["d_lat"]["w"], params["d_lat"]["b"]))
    for name, size in CONV_DECODER:
        h = F.interpolate(h, size=size, mode="linear", align_corners=False)
        h = F.conv_transpose1d(h, params[name]["w"], params[name]["b"], stride=2, padding=1, output_padding=1)
        if name != "d4":
            h = torch.relu(h)
        if name == "d2":
            h = _drop(h, k[1], rate)
    return h, z


MODELS = {"LSTMAutoencoder": lstm_ae, "LeNet5AutoencoderAvgPool": conv_ae}


def dropout_shapes(model_class: str, B: int, T: int, widths=None):
    """The activations' shapes at each dropout, in the order of the draws;
    ``widths``: the LSTM's two hidden sizes, or the conv encoder's four
    channel counts (the reference's where None)."""
    if model_class == "LSTMAutoencoder":
        h1, h2 = widths or (128, 64)
        return [(B, T, h1), (B, T, h2), (B, T, h2), (B, T, h1)]
    c1 = (widths or (16, 32, 64, 128))[1]
    return [(B, c1, T // 8), (B, c1, T // 16)]


def keep_masks(generator: torch.Generator, shapes, rate: float, device) -> List[torch.Tensor]:
    """One step's dropout masks: a float32 uniform draw of each shape in
    turn from ``generator``, kept below 1 - rate."""
    return [torch.rand(s, generator=generator, device=device) < 1.0 - rate for s in shapes]


@torch.no_grad()
def reconstruct(model_class: str, params: Tree, rows: torch.Tensor, dtype, block: int = 2048,
                alter=None) -> torch.Tensor:
    """The eval-mode (no dropout) reconstruction of each of ``rows`` (n, ...)
    in the model's layout, in ``dtype``, ``block`` rows at a time; ``alter``
    changes each block's latents (a planted fault)."""
    forward = MODELS[model_class]
    p = {k: {n: v.to(dtype) for n, v in layer.items()} for k, layer in params.items()}
    return torch.cat([forward(p, rows[i:i + block].to(dtype), alter=alter)[0] for i in range(0, len(rows), block)])


def mse(pred: torch.Tensor, x: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's mean squared error: the mean of each row's mean, over
    the rows of weight 1 (all of them where ``weights`` is None)."""
    per_row = ((pred - x) ** 2).reshape(x.shape[0], -1).mean(dim=1)
    if weights is None:
        return per_row.mean()
    return (per_row * weights).sum() / weights.sum()


class Adam:
    """optax's ``scale_by_adam`` then the learning rate: m and v moved by
    (1 - beta) g and (1 - beta) g^2, bias-corrected, m_hat / (sqrt(v_hat) +
    eps) * -lr."""

    def __init__(self, params: Tree, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: {n: torch.zeros_like(p) for n, p in layer.items()} for k, layer in params.items()}
        self.v = {k: {n: torch.zeros_like(p) for n, p in layer.items()} for k, layer in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, layer in params.items():
            for n, p in layer.items():
                g = grads[k][n]
                m = self.m[k][n].mul_(self.b1).add_((1.0 - self.b1) * g)
                v = self.v[k][n].mul_(self.b2).add_((1.0 - self.b2) * g * g)
                p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def train_steps(model_class: str, init: Tree, batches: List[torch.Tensor], keeps: List[List[torch.Tensor]],
                rate: float, lr: float, dtype, weights: Optional[List[torch.Tensor]] = None):
    """Steps of the reference trainer from ``init`` over ``batches`` (each
    (B, ...) in the model's layout), with one step's dropout masks each.
    Returns the losses, the first step's gradients and the parameters
    after the last step, all in ``dtype``."""
    forward = MODELS[model_class]
    params = {k: {n: p.detach().to(dtype).clone().requires_grad_(True) for n, p in layer.items()}
              for k, layer in init.items()}
    opt = Adam(params, lr)
    losses, first_grads = [], None
    for i, x in enumerate(batches):
        x = x.to(dtype)
        pred, _ = forward(params, x, keeps[i], rate)
        loss = mse(pred, x, None if weights is None else weights[i].to(dtype))
        leaves = [(k, n, p) for k, layer in params.items() for n, p in layer.items()]
        grads_flat = torch.autograd.grad(loss, [p for _, _, p in leaves])
        grads: Tree = {}
        for (k, n, _), g in zip(leaves, grads_flat):
            grads.setdefault(k, {})[n] = g
        if first_grads is None:
            first_grads = {k: {n: g.detach().clone() for n, g in layer.items()} for k, layer in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(params, grads)
    return losses, first_grads, {k: {n: p.detach() for n, p in layer.items()} for k, layer in params.items()}
