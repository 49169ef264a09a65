"""The port's conv autoencoder (``LeNet5AutoencoderAvgPool``) and its layer
helpers against the JAX package, on the CPU.

Inputs come from numpy seeds; the weights are the JAX package's
``conv_ae.init(PRNGKey(0), 10)``, carried across by the bridge.

Tolerances: each layer helper 1e-6 at the conv autoencoder's shapes (one
float32 convolution, pool or resize); ``forward`` and ``encode`` 1e-5
(``PARITY.md:28``); weights across the bridge and checkpoints bit-exact;
``Scorer`` latents 2e-5, reconstruction 1e-4 and probability 1e-5, as the
serving slice holds them.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.classify.gbt import GBTClassifier as JaxGBTClassifier
from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.models import conv_ae
from ae_waveforms_tpu.models import layers as jax_layers
from ae_waveforms_tpu.serve import Scorer as JaxScorer
from ae_waveforms_tpu.train import checkpoint as jax_ckpt
from ae_waveforms_tpu_torch.bridge import conv_ae_params_from_numpy, conv_ae_params_to_numpy, gbt_from_numpy
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.models import layers
from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.serve import Scorer
from ae_waveforms_tpu_torch.train import checkpoint as torch_ckpt

CONV = "LeNet5AutoencoderAvgPool"
RUN = "conv-run"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (as in
    ``tests/test_torch_train_loop.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(seed=0, latent=10):
    return jax.tree_util.tree_map(np.asarray, conv_ae.init(jax.random.PRNGKey(seed), latent))


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# (layer, input shape, stride, padding, output_padding): every convolution of the conv AE at B = 4
CONVS = [("e1", (4, 1, 320), 2, 1), ("e2", (4, 16, 80), 2, 1), ("e3", (4, 32, 20), 2, 1), ("e4", (4, 64, 5), 2, 1),
         ("e_lat", (4, 128, 1), 1, 0)]
DECONVS = [("d_lat", (4, 10, 1), 1, 0, 0), ("d1", (4, 128, 3), 2, 1, 1), ("d2", (4, 64, 10), 2, 1, 1),
           ("d3", (4, 32, 40), 2, 1, 1), ("d4", (4, 16, 160), 2, 1, 1)]


@pytest.mark.parametrize("name,shape,stride,padding", CONVS)
def test_conv1d_apply_matches_jax(name, shape, stride, padding):
    p = _jax_params()[name]
    x = _x(np.random.default_rng(1), shape)
    want = np.asarray(jax_layers.conv1d_apply(p, jnp.asarray(x), stride=stride, padding=padding))
    got = layers.conv1d_apply({k: torch.tensor(v) for k, v in p.items()}, torch.from_numpy(x), stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,shape,stride,padding,output_padding", DECONVS)
def test_conv1d_transpose_apply_matches_jax(name, shape, stride, padding, output_padding):
    p = _jax_params()[name]
    x = _x(np.random.default_rng(2), shape)
    want = np.asarray(jax_layers.conv1d_transpose_apply(p, jnp.asarray(x), stride, padding, output_padding))
    got = layers.conv1d_transpose_apply({k: torch.tensor(v) for k, v in p.items()}, torch.from_numpy(x),
                                        stride, padding, output_padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 16, 160), (4, 32, 40), (4, 64, 10), (4, 128, 3)])
def test_avg_pool1d_matches_jax(shape):
    x = _x(np.random.default_rng(3), shape)
    want = np.asarray(jax_layers.avg_pool1d(jnp.asarray(x)))
    got = layers.avg_pool1d(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:2], shape[2] // 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels,length,size", [(128, 1, 3), (64, 6, 10), (32, 20, 40), (16, 80, 160)])
def test_upsample_linear_matches_jax_image_resize(channels, length, size):
    x = _x(np.random.default_rng(4), (4, channels, length))
    want = np.asarray(jax_layers.upsample_linear(jnp.asarray(x), size))
    got = layers.upsample_linear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == (4, channels, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_upsample_linear_refuses_to_shrink():
    with pytest.raises(ValueError, match="would shrink"):
        layers.upsample_linear(torch.zeros(1, 1, 10), 6)


def test_forward_and_encode_match_jax_at_full_width():
    params = _jax_params()
    model = conv_ae_params_from_numpy(params, device="cpu")
    x = _x(np.random.default_rng(5), (4, 1, 320))
    with torch.no_grad():
        pred, z = model(torch.from_numpy(x)).numpy(), model.encode(torch.from_numpy(x)).numpy()
    want_pred, want_z = np.asarray(conv_ae.forward(params, x)), np.asarray(conv_ae.encode(params, x))
    assert pred.shape == want_pred.shape == (4, 1, 320) and z.shape == want_z.shape == (4, 10, 1)
    np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-5)
    np.testing.assert_allclose(z, want_z, rtol=0, atol=1e-5)


def test_train_mode_dropout_uses_the_generator_only():
    """At rate 0 the train-mode forward is the eval-mode one; with dropout
    the same generator state gives the same output, another state another."""
    model = LeNet5AutoencoderAvgPool(generator=torch.Generator().manual_seed(3), device="cpu")
    x = torch.from_numpy(_x(np.random.default_rng(6), (2, 1, 320)))
    with torch.no_grad():
        plain = model.eval()(x)
        model.train()
        torch.testing.assert_close(model(x, 0.0), plain, rtol=0, atol=0)
        a, b, c = (model(x, 0.2, torch.Generator().manual_seed(s)) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)


def test_bridge_round_trip_bit_exact():
    params = _jax_params(seed=1)
    model = conv_ae_params_from_numpy(params, device="cpu")
    assert not model.training
    back = conv_ae_params_to_numpy(model)
    assert sorted(back) == sorted(params)
    for name in params:
        assert sorted(back[name]) == sorted(params[name])
        for k in params[name]:
            assert back[name][k].dtype == params[name][k].dtype and np.array_equal(back[name][k], params[name][k])


def test_leaf_order_matches_jax_tree_util():
    params = _jax_params()
    jax_leaves = jax.tree_util.tree_leaves(params)
    port_leaves = torch_ckpt.tree_leaves(params)
    assert len(jax_leaves) == len(port_leaves) == 20
    assert all(a is b for a, b in zip(jax_leaves, port_leaves))
    # sorted keys: d1, d2, d3, d4, d_lat, e1, ..., e_lat, each b before w
    assert port_leaves[0] is params["d1"]["b"] and port_leaves[-1] is params["e_lat"]["w"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    params = _jax_params(seed=2)
    path = str(tmp_path / "model_autoencoder.npz")
    if writer == "jax":
        jax_ckpt.save_state(path, params)
        model = LeNet5AutoencoderAvgPool(device="cpu")
        model.load_jax_tree(torch_ckpt.load_state(path, model.jax_tree()))
        got = conv_ae_params_to_numpy(model)
    else:
        torch_ckpt.save_state(path, conv_ae_params_from_numpy(params, device="cpu").jax_tree())
        got = jax_ckpt.load_state(path, _jax_params(seed=3))
    for name in params:
        for k in params[name]:
            assert np.array_equal(np.asarray(got[name][k]), params[name][k]), (name, k)


@pytest.mark.parametrize("name", ["e1", "e2", "e3", "e4", "e_lat", "d_lat", "d1", "d2", "d3", "d4"])
def test_init_bounds_fan_in_over_in_channels_and_kernel(name):
    """uniform(+-1/sqrt(in_ch * K)) for every layer, transposed ones too
    (torch's own ConvTranspose1d init would fan on out_ch * K)."""
    model = LeNet5AutoencoderAvgPool(generator=torch.Generator().manual_seed(4), device="cpu")
    w, b = model.jax_tree()[name]["w"].detach(), model.jax_tree()[name]["b"].detach()
    in_ch = w.shape[0] if name.startswith("d") else w.shape[1]
    bound = 1.0 / math.sqrt(in_ch * w.shape[2])
    for t in (w, b):
        assert float(t.abs().max()) <= bound
        if t.numel() >= 16:  # a draw this large reaches past half the bound
            assert float(t.abs().max()) > 0.5 * bound


def test_registry_names_the_conv_model_channel_first():
    mdef = model_def(CONV)
    assert mdef.channel_first and mdef.build is LeNet5AutoencoderAvgPool


def test_decoder_refuses_another_length():
    model = LeNet5AutoencoderAvgPool(device="cpu").eval()
    with torch.no_grad(), pytest.raises(ValueError, match="320 samples long, not 1"):
        model.decode(torch.zeros(1, 10, 1), 1)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    results = str(tmp_path_factory.mktemp("results"))
    jax_ckpt.save_state(os.path.join(results, "networks_autoencoder", RUN, "model_autoencoder.npz"), _jax_params())
    rng = np.random.default_rng(0)
    waves = rng.standard_normal((5, 320)).astype(np.float32)
    jscorer = JaxScorer.from_run(results, RUN, JaxTrainConfig(model_class=CONV))
    scorer = Scorer.from_run(results, RUN, TrainConfig(model_class=CONV), device="cpu")
    out = {"AE": (jscorer.score(waves, bucket=8), scorer.score(waves, bucket=8))}
    # the head is fitted on other latent-shaped data, so no scored latent
    # sits on a bin edge (a float-rounding flip there changes the leaf)
    z = out["AE"][0]["latents"]
    X = (z.mean(0) + z.std(0) * rng.standard_normal((200, z.shape[1]))).astype(np.float32)
    y = (X[:, 0] > np.median(X[:, 0])).astype(np.float32)
    jgbt = JaxGBTClassifier(max_depth=3, n_estimators=10, random_state=0).fit(X, y)
    e = jgbt._ens
    gbt = gbt_from_numpy(e.feat, e.thresh, e.is_split, e.leaf, e.lr, jgbt._edges, jgbt.get_params(), device="cpu")
    out["AE+GBT"] = (jscorer.attach_gbt(jgbt).score(waves, bucket=8), scorer.attach_gbt(gbt).score(waves, bucket=8))
    return out


TOLERANCES = [("latents", 2e-5), ("reconstruction", 1e-4), ("rmse", 1e-4)]


@pytest.mark.parametrize("head,key,atol", [("AE", k, t) for k, t in TOLERANCES]
                         + [("AE+GBT", k, t) for k, t in TOLERANCES + [("probability", 1e-5)]])
def test_scorer_matches_jax(scored, head, key, atol):
    """Latents come out (n, d) for the conv model, as the JAX ``Scorer``
    squeezes them, and the decoder gets the beat length, not the channel
    count."""
    out_j, out_t = scored[head]
    assert sorted(out_t) == sorted(out_j)
    assert out_t["latents"].shape == (5, 10) and out_t["reconstruction"].shape == (5, 320)
    assert out_t[key].shape == out_j[key].shape and np.all(np.isfinite(out_t[key]))
    np.testing.assert_allclose(out_t[key], out_j[key], atol=atol, rtol=0)
