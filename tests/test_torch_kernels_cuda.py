"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test decides inside itself whether a card is present
and skips with a reason when none is.  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.ops.gbt_hist import (
    fixed_point_shift,
    left_histograms,
    left_histograms_fixed,
    left_histograms_fixed_reference,
    left_histograms_reference,
)
from ae_waveforms_tpu_torch.ops.gbt_route import route_rows, route_rows_reference
from ae_waveforms_tpu_torch.ops.lstm_encoder import encode_fused, encode_fused_reference

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("B,T,hidden,latent", [(64, 320, (128, 64), 10), (1, 320, (128, 64), 2),
                                               (5, 40, (16, 8), 20)])
def test_encoder_kernel_matches_plain(B, T, hidden, latent):
    dev = _card()
    model = LSTMAutoencoder(latent, hidden, generator=torch.Generator().manual_seed(B), device=dev)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, T, 1)).astype(np.float32)).to(dev)
    before = encode_fused.launches
    with torch.no_grad():
        got = encode_fused(model.jax_tree(), x)
        ref = encode_fused_reference(model.jax_tree(), x)
    torch.cuda.synchronize()
    assert encode_fused.launches == before + 1
    assert (got - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("S,n,n_nodes", [(100, 64, 1), (100, 256, 32), (3, 1000, 1024)])
def test_route_kernel_matches_plain_exactly(S, n, n_nodes):
    dev = _card()
    rng = np.random.default_rng(n_nodes)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    binsT = t(rng.integers(0, 64, size=(10, n)).astype(np.int32))
    node = t(rng.integers(0, n_nodes, size=(S, n)).astype(np.int32))
    bf = t(rng.integers(0, 10, size=(S, n_nodes)).astype(np.int32))
    bb = t(rng.integers(0, 64, size=(S, n_nodes)).astype(np.int32))
    do = t(rng.random((S, n_nodes)) < 0.7)
    got = route_rows(binsT, node, bf, bb, do)
    assert torch.equal(got, route_rows_reference(binsT, node, bf, bb, do))


@pytest.mark.parametrize("S,n,half", [(96, 12000, 16), (24, 12000, 256), (3, 37, 2)])
def test_hist_kernel_matches_plain_and_is_deterministic(S, n, half):
    dev = _card()
    rng = np.random.default_rng(half)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    binsT = t(rng.integers(0, 64, size=(10, n)).astype(np.int32))
    g = t(rng.standard_normal((S, n)).astype(np.float32))
    h = t(rng.uniform(0, 1, (S, n)).astype(np.float32))
    node = t(rng.integers(-1, 2 * half + 1, size=(S, n)).astype(np.int32))
    shift = fixed_point_shift(g, h)
    before = left_histograms_fixed.launches
    q1 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=64)
    q2 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=64)
    assert left_histograms_fixed.launches == before + 2
    assert torch.equal(q1, q2)  # bit-identical across calls
    assert torch.equal(q1, left_histograms_fixed_reference(binsT, g, h, node, shift, half=half, n_bins=64))
    got = left_histograms(binsT, g, h, node, half=half, n_bins=64)
    torch.testing.assert_close(got, left_histograms_reference(binsT, g, h, node, half=half, n_bins=64),
                               atol=1e-4, rtol=1e-5)


def test_wrappers_raise_on_unsupported_input():
    dev = _card()
    model = LSTMAutoencoder(10, device=dev)
    with pytest.raises(ValueError):
        encode_fused(model.jax_tree(), torch.zeros((2, 8, 1), dtype=torch.float64, device=dev))
    z = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        route_rows(z.float(), z, z[:, :1], z[:, :1], z[:, :1].bool())
    g = torch.zeros((2, 4), device=dev)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g.double(), g, z, z[:, 0], half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g, g, z, z[:, 0].cpu(), half=1, n_bins=64)
    with pytest.raises(RuntimeError):  # more bins than a block's shared memory holds
        left_histograms_fixed(z, g, g, z, z[:, 0], half=1, n_bins=8192)
