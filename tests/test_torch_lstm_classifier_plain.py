"""The port's end-to-end LSTM classifier (``models/lstm_classifier.py``)
and its stacked training step (``classify/dl.py``) against the benchmark's
plain reference (``portbench/reference/classifier.py``), on the CPU at the
published widths (LSTMs 1 -> 128 -> 64 -> 64, attention 64 -> 1, FC
64 -> 32 -> 1), T = 32 and B = 16, from seeded random weights and
BatchNorm state; the dropout masks the reference replays from the same
seeded generators.

Both sides run in float64, so what separates them is only the order of
their sums (``torch.lstm``'s fused products against the reference's time
loop, the port's products-and-sums dense layers against an einsum):

- probabilities and the BatchNorm state 1e-10 absolute (they are of order
  1 and their float64 rounding is about 1e-15);
- losses 1e-10 relative;
- gradients 1e-9 of each leaf's largest |g| plus 1e-12: the attention's
  bias has a gradient of 0 but for rounding (a softmax ignores a shift);
- parameters after Adam 1e-10 absolute, a millionth of the step: a first
  Adam step moves a weight by lr = 1e-4 times about the sign of its
  gradient, so only a gradient within rounding of 0 (the attention's bias
  again, whose |g| of 1e-16 or so Adam divides by itself plus eps = 1e-8)
  can move it differently, by up to lr x 1e-16 / 1e-8 a rounding.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.bridge import classifier_to_numpy
from ae_waveforms_tpu_torch.classify import dl
from ae_waveforms_tpu_torch.core.flops import dl_classifier_fwd_flops_per_sample
from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
from ae_waveforms_tpu_torch.train.stacked import StackedConfigs
from portbench.counts import classifier as counts
from portbench.reference import classifier as ref

T, B, RATE = 32, 16, 0.2
CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "lstm_classifier.json"


def model(seed: int) -> LSTMClassifier:
    """A float64 classifier of the seed's weights, its BatchNorm's gamma,
    beta and running statistics drawn too."""
    m = LSTMClassifier(generator=torch.Generator().manual_seed(seed), device="cpu").double()
    g = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        m.bn_gamma.copy_(0.5 + torch.rand(64, generator=g, dtype=torch.float64))
        m.bn_beta.copy_(torch.randn(64, generator=g, dtype=torch.float64))
        m.bn_mean.copy_(0.1 * torch.randn(64, generator=g, dtype=torch.float64))
        m.bn_var.copy_(0.05 + 0.1 * torch.rand(64, generator=g, dtype=torch.float64))
    return m


def flat(models):
    """The models' parameters and BatchNorm state as the reference's
    (S, ...) float64 tensors."""
    trees = [classifier_to_numpy(m) for m in models]
    params = {k: torch.from_numpy(np.stack([ref.flatten(p)[k] for p, _ in trees])) for k in ref.flatten(trees[0][0])}
    state = {k: torch.from_numpy(np.stack([s[k] for _, s in trees])) for k in trees[0][1]}
    return params, state


def beats(S: int, n: int, seed: int = 7):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, n, T, 1), generator=g, dtype=torch.float64).cumsum(2) * 0.3
    y = (torch.rand((S, n), generator=g) < 0.5).double()
    return x, y


def keeps(seeds, steps: int = 1):
    """Each step's two keep masks (S, B, T, H), drawn as the port draws them
    from each seed's generator."""
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    out = []
    for _ in range(steps):
        per = [ref.keep_masks(g, ref.dropout_shapes(B, T), RATE, "cpu") for g in gens]
        out.append([torch.stack([p[k] for p in per]) for k in range(2)])
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward(train):
    m = model(3).train(train)
    x, _ = beats(1, B)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        got = m(x[0], RATE, gen)[:, 0]
    params, state = flat([model(3)])
    want, _ = ref.forward(params, state, x, train, keeps([5])[0] if train else None, RATE)
    assert float((got - want[0]).abs().max()) < 1e-10


def test_last_lstm_outputs(monkeypatch):
    """The train-mode pass's last LSTM outputs, which the benchmark's check
    holds as ``lstm_gap``, against the reference's ``taps``."""
    from ae_waveforms_tpu_torch.models import lstm_classifier as lc

    m = model(2).train()
    seen = []
    lstm_forward = lc.lstm_forward

    def kept(lstm, h):
        out = lstm_forward(lstm, h)
        seen.append(out[0])
        return out

    monkeypatch.setattr(lc, "lstm_forward", kept)
    x, _ = beats(1, B)
    with torch.no_grad():
        m(x[0], RATE, torch.Generator().manual_seed(4))
    taps = {}
    params, state = flat([model(2)])
    ref.forward(params, state, x, True, keeps([4])[0], RATE, taps=taps)
    assert len(seen) == 3 and taps["lstm3"].shape == (1, B, T, 64)
    assert float((seen[-1] - taps["lstm3"][0]).abs().max()) < 1e-10


def test_lstm_backward_and_head_from_the_ports_inputs(monkeypatch):
    """The two parts of a first step that the benchmark's check holds
    apart: the reference's LSTM backward fed the gradient that the port's
    backward fed into the last LSTM's outputs (``lstm_grads``), and the
    reference's head fed the port's last-LSTM outputs (``head_grads``),
    each against the port's own gradients of those parameters."""
    from ae_waveforms_tpu_torch.models import lstm_classifier as lc

    m = model(10).train()
    outputs, upstream = [], []
    lstm_forward = lc.lstm_forward

    def kept(lstm, h):
        out = lstm_forward(lstm, h)
        if lstm is m.lstm3:
            outputs.append(out[0].detach())
            out[0].register_hook(lambda g: upstream.append(g.detach()))
        return out

    monkeypatch.setattr(lc, "lstm_forward", kept)
    x, y = beats(1, B)
    mask = torch.ones(B, dtype=torch.bool)
    dl.batch_bce(m, x[0], y[0], torch.arange(B), mask, torch.Generator().manual_seed(12), RATE, None).backward()
    params, state = flat([model(10)])
    taps = {}
    ref.train_steps(params, state, [(x, y, mask[None].double())], keeps([12]), RATE, 0.0, torch.float64, taps=taps,
                    upstream=upstream[0][None], lstm3=outputs[0][None])
    got = ref.flatten(m.jax_tree())
    want = {**taps["lstm_grads"], **taps["head_grads"]}
    assert set(want) == set(got)
    for k, g in want.items():
        assert float((got[k].grad - g[0]).abs().max()) <= 1e-9 * float(g.abs().max()) + 1e-12, k


def test_batchnorm_update():
    """Three train-mode passes: the running mean and variance (momentum 0.1
    towards the batch mean and the unbiased variance) after each."""
    m = model(4).train()
    params, state = flat([model(4)])
    gen = torch.Generator().manual_seed(6)
    for k, keep in enumerate(keeps([6], steps=3)):
        x, _ = beats(1, B, seed=20 + k)
        with torch.no_grad():
            m(x[0], RATE, gen)
        _, state = ref.forward(params, state, x, True, keep, RATE)
        assert float((m.bn_mean - state["bn_mean"][0]).abs().max()) < 1e-10
        assert float((m.bn_var - state["bn_var"][0]).abs().max()) < 1e-10


def test_bce_gradients():
    """The masked, clipped BCE of a padded batch (the last 5 rows padding)
    and its gradient in every leaf."""
    m = model(8).train()
    x, y = beats(1, B)
    idx = torch.arange(B)
    idx[-5:] = 0
    mask = torch.arange(B) < B - 5
    loss = dl.batch_bce(m, x[0], y[0], idx, mask, torch.Generator().manual_seed(9), RATE, None)
    loss.backward()
    loss = float(loss.detach())
    params, state = flat([model(8)])
    losses, grads, _, _ = ref.train_steps(params, state, [(x[:, idx], y[:, idx], mask[None].double())], keeps([9]),
                                          RATE, 0.0, torch.float64)
    assert abs(loss - losses[0, 0]) <= 1e-10 * abs(losses[0, 0])
    for k, p in ref.flatten(m.jax_tree()).items():
        assert float((p.grad - grads[k][0]).abs().max()) <= 1e-9 * float(grads[k].abs().max()) + 1e-12, k


def test_stacked_step_of_three_seeds(monkeypatch):
    """One ``dl.stacked_step`` of 3 seeds on a padded batch (11 rows of 16
    kept, the padding row 0): each seed's loss, gradients, Adam update and
    BatchNorm state against the reference's step."""
    seeds = [11, 12, 13]
    models = [model(s) for s in seeds]
    stacked = StackedConfigs(model(0).train(), models, "cpu")
    optimizer = dl._Adam(stacked.param_groups(), lr=1e-4)
    x, y = beats(3, 24)
    perm = torch.stack([torch.randperm(24, generator=torch.Generator().manual_seed(s))[:B] for s in seeds])
    mask = torch.arange(B).expand(3, B) < 11
    idx = torch.where(mask, perm, 0)
    losses, batch_bce = [], dl.batch_bce

    def recorded(*args):
        losses.append(batch_bce(*args))
        return losses[-1]

    monkeypatch.setattr(dl, "batch_bce", recorded)
    dl.stacked_step(stacked, optimizer, [0, 1, 2], x, y, idx, mask, [torch.Generator().manual_seed(s) for s in seeds],
                    RATE, None)

    params, state = flat(models)
    rows = torch.arange(3)[:, None]
    want_losses, grads, end, end_state = ref.train_steps(params, state, [(x[rows, idx], y[rows, idx], mask.double())],
                                                         keeps(seeds), RATE, 1e-4, torch.float64)
    got_losses = np.array([float(v.detach()) for v in losses])
    assert np.all(np.abs(got_losses - want_losses[0]) <= 1e-10 * np.abs(want_losses[0]))
    for s in range(3):
        got = ref.flatten(_jax_named(stacked.leaves[s]))
        for k, g in grads.items():
            assert float((got[k].grad - g[s]).abs().max()) <= 1e-9 * float(g[s].abs().max()) + 1e-12, (s, k)
            assert float((got[k].detach() - end[k][s]).abs().max()) <= 1e-10, (s, k)
        for k in ("bn_mean", "bn_var"):
            assert float((stacked.buffers[k][s] - end_state[k][s]).abs().max()) < 1e-10


def _jax_named(leaves):
    """A stacked config's leaves (torch names) under the JAX names."""
    names = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh", "bias_ih_l0": "b_ih", "bias_hh_l0": "b_hh",
             "weight": "w", "bias": "b"}
    tree = {}
    for name, p in leaves.items():
        layer, _, leaf = name.rpartition(".")
        if layer:
            tree.setdefault(layer, {})[names[leaf]] = p
        else:
            tree[name] = p
    return tree


def test_flop_counts_equal_the_ports():
    config = json.loads(CONFIG.read_text())
    assert counts.fwd_per_beat(config) == dl_classifier_fwd_flops_per_sample(config["beat_length"])
    assert counts.train_per_beat(config) == 3 * dl_classifier_fwd_flops_per_sample()
