"""Inputs and weights made from ``--seed``, on the run's device, in a few
large calls of one ``torch.Generator``: the same seed gives the same inputs.

The beats follow ``chip_smoke.synthetic_beats`` (P, Q, R, S and T bumps,
the R peak at a third of the beat, seeded amplitudes, jitter, scale,
offset and noise); the classifier cohorts follow its ``write_latent_dir``
(Gaussian latents, the sick class shifted on four of the ten).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

T_BEAT = 320
R_SAMPLE = 106
WAVE_WIDTHS = (10, 3, 4, 3, 20)


def generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` and a named stream of it."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def beats(n: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, 320) float32 ECG-like median beats on ``device``."""
    f = dict(generator=g, device=device, dtype=torch.float32)
    t = torch.arange(T_BEAT, device=device, dtype=torch.float32)[None, :]
    a = 0.7 + 0.6 * torch.rand((n, 5), **f)
    j = 4.0 * torch.randn((n, 2), **f)
    bump = lambda c, w: torch.exp(-0.5 * ((t - c) / w) ** 2)  # noqa: E731
    wp, wq, wr, ws, wt = WAVE_WIDTHS
    w = (0.15 * a[:, :1] * bump(60 + j[:, :1], wp) - 0.1 * a[:, 1:2] * bump(98, wq)
         + a[:, 2:3] * bump(R_SAMPLE, wr) - 0.2 * a[:, 3:4] * bump(114, ws)
         + 0.3 * a[:, 4:5] * bump(210 + j[:, 1:], wt))
    w = w * (0.3 + 2.7 * torch.rand((n, 1), **f)) + 0.5 * torch.randn((n, 1), **f)
    return w + 0.02 * torch.randn((n, T_BEAT), **f)


def case_ids(n: int, n_ids: int) -> np.ndarray:
    """The case id of each of ``n`` beats: ``n_ids`` cases of nearly equal
    size, in order (the same for every seed)."""
    return (np.arange(n, dtype=np.int64) * n_ids // n + 1000).astype(np.float64)


def uniform_tree(shapes: Dict[str, Dict[str, Tuple[Tuple[int, ...], float]]], g: torch.Generator,
                 device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A parameter tree of uniform(-bound, bound) leaves from one draw:
    ``shapes[layer][leaf] = (shape, bound)``."""
    sizes = [math.prod(s) for layer in shapes.values() for s, _ in layer.values()]
    flat = 2.0 * torch.rand(sum(sizes), generator=g, device=device) - 1.0
    out, at = {}, 0
    for name, layer in shapes.items():
        out[name] = {}
        for leaf, (shape, bound) in layer.items():
            k = math.prod(shape)
            out[name][leaf] = (flat[at:at + k] * bound).view(shape)
            at += k
    return out


def lstm_ae_shapes(latent: int = 10, hidden=(128, 64)):
    h1, h2 = hidden
    layers = {"enc1": (1, h1), "enc2": (h1, h2), "enc3": (h2, latent),
              "dec1": (latent, h2), "dec2": (h2, h1), "dec3": (h1, 1)}
    shapes = {}
    for name, (i, h) in layers.items():
        k = 1.0 / math.sqrt(h)
        shapes[name] = {"w_ih": ((4 * h, i), k), "w_hh": ((4 * h, h), k), "b_ih": ((4 * h,), k), "b_hh": ((4 * h,), k)}
    shapes["out"] = {"w": ((1, 1), 1.0), "b": ((1,), 1.0)}
    return shapes


def conv_ae_shapes(latent: int = 10, channels=(16, 32, 64, 128)):
    """The conv AE's leaves: encoder e1..e4 from 1 channel through
    ``channels``, the 1 x 1 latent convolutions, and the decoder d1..d4
    mirroring them back to 1 channel."""
    def conv(i, o, k, transpose=False):
        b = 1.0 / math.sqrt(i * k)
        return {"w": (((i, o, k) if transpose else (o, i, k)), b), "b": ((o,), b)}

    widths = (1,) + tuple(channels)
    shapes = {f"e{k + 1}": conv(widths[k], widths[k + 1], 3) for k in range(4)}
    shapes["e_lat"] = conv(widths[-1], latent, 1)
    shapes["d_lat"] = conv(latent, widths[-1], 1, transpose=True)
    shapes.update({f"d{k + 1}": conv(widths[4 - k], widths[3 - k], 3, transpose=True) for k in range(4)})
    return shapes


def model_shapes(config: dict):
    if config["model_class"] == "LSTMAutoencoder":
        return lstm_ae_shapes(config["latent_size"], tuple(config["hidden_sizes"]))
    return conv_ae_shapes(config["latent_size"], tuple(config["channels"]))


def cohorts(n_per: int, F: int, shift: float, shifted: int, g: torch.Generator, device) -> Tuple[np.ndarray, np.ndarray]:
    """Control and sick latents, (n_per, F) float32 each, the sick class's
    mean moved by ``shift`` on its first ``shifted`` latents."""
    z = torch.randn((2, n_per, F), generator=g, device=device, dtype=torch.float32)
    z[1, :, :shifted] += shift
    z = z.cpu().numpy()
    return z[0], z[1]
