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
    active_clusters,
    fixed_point_shift,
    hist_plan,
    left_histograms,
    left_histograms_fixed,
    left_histograms_fixed_reference,
    left_histograms_reference,
    pack_bins,
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
                                               (5, 40, (16, 8), 20), (256, 320, (128, 64), 10),
                                               (37, 320, (128, 64), 10)])
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


# (S, n, half, n_bins, share of rows with g = h = 0): the fit's shapes, rows
# not a multiple of the plan's cluster size, one fit, two-byte bins, rows
# that all carry no weight, and the deepest level of the deep bucket
@pytest.mark.parametrize("S,n,half,n_bins,zero", [
    (96, 12000, 16, 64, 0.0), (24, 12000, 256, 64, 0.0), (3, 37, 2, 64, 0.0), (96, 12000, 16, 64, 0.46),
    (6, 12001, 1, 64, 0.46), (1, 12000, 16, 64, 0.0), (5, 3000, 4, 300, 0.0), (4, 2000, 8, 64, 1.0),
    (6, 12000, 256, 64, 0.46),
])
def test_hist_kernel_matches_plain_and_is_deterministic(S, n, half, n_bins, zero):
    dev = _card()
    rng = np.random.default_rng(half + n)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    binsT = t(rng.integers(0, n_bins, size=(10, n)).astype(np.int32))
    keep = (rng.random((S, n)) >= zero).astype(np.float32)
    g = t(rng.standard_normal((S, n)).astype(np.float32) * keep)
    h = t(rng.uniform(0, 1, (S, n)).astype(np.float32) * keep)
    node = t(rng.integers(-1, 2 * half + 1, size=(S, n)).astype(np.int32))
    shift = fixed_point_shift(g, h)
    if (S, n) == (6, 12001):
        assert n % hist_plan(S, n, 10, n_bins, half, active_clusters(dev.index)).cluster != 0
    packed = pack_bins(binsT, n_bins)
    before = left_histograms_fixed.launches
    q1 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=n_bins, packed=packed)
    q2 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=n_bins)
    assert left_histograms_fixed.launches == before + 2
    assert torch.equal(q1, q2)  # bit-identical across calls, packed once or per call
    assert torch.equal(q1, left_histograms_fixed_reference(binsT, g, h, node, shift, half=half, n_bins=n_bins))
    got = left_histograms(binsT, g, h, node, half=half, n_bins=n_bins)
    torch.testing.assert_close(got, left_histograms_reference(binsT, g, h, node, half=half, n_bins=n_bins),
                               atol=1e-4, rtol=1e-5)


def test_wrappers_raise_on_unsupported_input():
    dev = _card()
    model = LSTMAutoencoder(10, device=dev)
    with pytest.raises(ValueError):
        encode_fused(model.jax_tree(), torch.zeros((2, 8, 1), dtype=torch.float64, device=dev))
    wide = LSTMAutoencoder(10, (1024, 64), device=dev)
    with pytest.raises(ValueError):  # a block's share of the weights exceeds its shared memory
        encode_fused(wide.jax_tree(), torch.zeros((2, 8, 1), device=dev))
    z = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        route_rows(z.float(), z, z[:, :1], z[:, :1], z[:, :1].bool())
    g = torch.zeros((2, 4), device=dev)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g.double(), g, z, z[:, 0], half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g, g, z, z[:, 0].cpu(), half=1, n_bins=64)
    with pytest.raises(ValueError):  # more bins than a block's shared memory holds
        left_histograms_fixed(z, g, g, z, z[:, 0].contiguous(), half=1, n_bins=16384)
    with pytest.raises(ValueError):  # packed bins of another pool
        left_histograms_fixed(z, g, g, z, z[:, 0].contiguous(), half=1, n_bins=64, packed=pack_bins(z[:, :2], 64))
