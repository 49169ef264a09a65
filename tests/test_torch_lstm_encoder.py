"""The port's fused LSTM encoder (plain version on the CPU) and LSTM
autoencoder against the JAX package: the Pallas kernel in interpret mode,
``lstm_ae.latent_of`` and ``lstm_ae.forward``.

Tolerance 2e-5 in float32: the sums run in another order (PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.models import layers as jax_layers
from ae_waveforms_tpu.models import lstm_ae
from ae_waveforms_tpu.ops.lstm_pallas import encode_fused as jax_encode_fused
from ae_waveforms_tpu_torch.bridge import lstm_ae_params_from_numpy
from ae_waveforms_tpu_torch.models import layers
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.lstm_encoder import SMEM_BUDGET, encode_fused, encode_fused_reference, encoder_plan

ATOL = 2e-5


def _case(widths, seed, B=4, T=32):
    h1, h2, latent = widths
    params = lstm_ae.init(jax.random.PRNGKey(seed), latent, hidden_sizes=(h1, h2))
    x = np.random.default_rng(seed).standard_normal((B, T, 1)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("widths", [(128, 64, 10), (16, 8, 4)])
def test_encode_fused_matches_jax(widths):
    params, x = _case(widths, seed=widths[0])
    model = lstm_ae_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    with torch.no_grad():
        got = encode_fused(model.jax_tree(), torch.from_numpy(x)).numpy()
    assert _build.launches["lstm_encoder"] == 0  # CPU tensors run the plain version
    kernel = np.asarray(jax_encode_fused(params, jnp.asarray(x), interpret=True))
    scan = np.asarray(lstm_ae.latent_of(params, jnp.asarray(x)))
    assert got.shape == (x.shape[0], widths[2]) and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, scan, atol=ATOL, rtol=0)


def test_forward_matches_jax():
    params, x = _case((128, 64, 10), seed=3)
    model = lstm_ae_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        z = model.latent_of(torch.from_numpy(x))
        np.testing.assert_array_equal(model.decode(z, x.shape[1]).numpy(), got)
    ref = np.asarray(lstm_ae.forward(params, jnp.asarray(x)))
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_layers_match_jax():
    jp = jax_layers.lstm_init(jax.random.PRNGKey(5), 3, 7)
    lin = jax_layers.linear_init(jax.random.PRNGKey(6), 7, 2)
    x = np.random.default_rng(5).standard_normal((2, 9, 3)).astype(np.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    tl = {k: torch.tensor(np.asarray(v)) for k, v in lin.items()}
    out, h = layers.lstm_apply(tp, torch.from_numpy(x))
    jout, jh = jax_layers.lstm_apply(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    y = layers.linear_apply(tl, out).numpy()
    np.testing.assert_allclose(y, np.asarray(jax_layers.linear_apply(lin, jout)), atol=ATOL, rtol=0)


def test_generator_init_is_seeded_and_torch_shaped():
    a = layers.lstm_init(torch.Generator().manual_seed(0), 3, 8)
    b = layers.lstm_init(torch.Generator().manual_seed(0), 3, 8)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w_ih": (32, 3), "w_hh": (32, 8), "b_ih": (32,), "b_hh": (32,)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.abs().max() <= 8 ** -0.5 for v in a.values())


def test_encoder_reference_matches_torch_lstm_stack():
    # the stacked per-step loop equals three torch.nn.LSTM layers in turn
    model = lstm_ae_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, lstm_ae.init(jax.random.PRNGKey(9), 6, hidden_sizes=(12, 8))),
        device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 20, 1)).astype(np.float32))
    with torch.no_grad():
        h = x
        for layer in (model.enc1, model.enc2, model.enc3):
            h, (h_last, _) = layer(h)
        got = encode_fused_reference(model.jax_tree(), x)
    np.testing.assert_allclose(got.numpy(), h_last[0].numpy(), atol=ATOL, rtol=0)


# the H100 holds 15 clusters of 8 of the kernel's blocks at once, so a grid
# stays within 15 clusters (one wave) while 32 rows per cluster allow it
@pytest.mark.parametrize("B,rows,clusters", [(64, 8, 8), (256, 32, 8), (1, 1, 1), (37, 4, 10), (60, 4, 15),
                                             (200, 16, 13), (512, 32, 16)])
def test_encoder_plan_rows_and_clusters(B, rows, clusters):
    plan = encoder_plan(B, 128, 64, 10)
    assert (plan.rows_per_cluster, plan.clusters) == (rows, clusters)
    assert plan.rows_per_cluster * plan.clusters >= B


@pytest.mark.parametrize("latent", [2, 10, 20])
def test_encoder_plan_fits_a_block_at_the_default_widths(latent):
    for B in (1, 64, 256):
        plan = encoder_plan(B, 128, 64, latent)
        assert 0 < plan.smem_bytes <= SMEM_BUDGET == 232_448
    # a block's share of the weights alone: 64 gate rows x 129, 32 x 192 and 8 x 74 floats
    assert encoder_plan(1, 128, 64, 10, T=0).smem_bytes >= 4 * (64 * 129 + 32 * 192 + 8 * 74)


def test_encoder_plan_refuses_an_over_wide_stack():
    with pytest.raises(ValueError, match="shared memory"):
        encoder_plan(64, 1024, 64, 10)


def test_model_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSTMAutoencoder(10)


def test_encoder_profile_instruments_the_kernel_source():
    # the profile tool edits a copy of the kernel source as text; a change to
    # the kernel that breaks its anchors shows here, not first on the card
    from ae_waveforms_tpu_torch.tools.encoder_profile import variants

    src = (_build.CSRC / _build.KERNELS["lstm_encoder"]).read_text()
    v = variants(src)
    assert v["kernel"] == src
    assert "barrier.cluster.arrive.relaxed" in v["relaxed"] and "cluster.sync();  // the one" not in v["relaxed"]
    assert "read_stamps" in v["stamped"] and v["stamped"].count("tp[") >= 6
