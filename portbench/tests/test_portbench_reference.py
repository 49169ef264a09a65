"""Each plain reference against the program at a small size on the CPU.
The test imports both; the references import nothing of the program."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import ae as ref_ae
from portbench.reference import gbt as ref_gbt
from portbench.reference import split as ref_split

CPU = torch.device("cpu")


def _weights(model_class, seed=3):
    config = {"model_class": model_class, "latent_size": 10, "hidden_sizes": [128, 64], "channels": [16, 32, 64, 128]}
    return data.uniform_tree(data.model_shapes(config), data.generator(CPU, seed, 2), CPU)


@pytest.mark.parametrize("model_class", ["LSTMAutoencoder", "LeNet5AutoencoderAvgPool"])
def test_autoencoder_forward(model_class):
    from ae_waveforms_tpu_torch.models.registry import build_model

    w = _weights(model_class)
    _, model = build_model(model_class, device="cpu")
    model.load_jax_tree(w)
    model.eval()
    x = data.beats(4, data.generator(CPU, 9, 1), CPU)
    x = x[:, None, :] if model_class != "LSTMAutoencoder" else x[:, :, None]
    with torch.no_grad():
        z, pred = model.encode(x), None
        pred = model.decode(z, 320)
    ref_pred, ref_z = ref_ae.MODELS[model_class]({k: {n: v.double() for n, v in l.items()} for k, l in w.items()},
                                                 x.double())
    assert float((z.double() - ref_z).abs().max()) < 1e-5
    assert float((pred.double() - ref_pred).abs().max()) < 1e-5


@pytest.mark.parametrize("model_class", ["LSTMAutoencoder", "LeNet5AutoencoderAvgPool"])
def test_one_train_step(model_class):
    from ae_waveforms_tpu_torch.models.registry import build_model
    from ae_waveforms_tpu_torch.train.loop import train_step
    from ae_waveforms_tpu_torch.train.optimizers import make_optimizer

    w = _weights(model_class)
    _, model = build_model(model_class, device="cpu")
    model.load_jax_tree(w)
    model.train()
    opt = make_optimizer("adam", model.parameters(), 1e-3)
    B = 4
    x = data.beats(B, data.generator(CPU, 11, 1), CPU)
    x = x[:, None, :] if model_class != "LSTMAutoencoder" else x[:, :, None]
    idx, mask = torch.arange(B), torch.ones(B, dtype=torch.bool)
    loss = train_step(model, opt, x, idx, mask, 1e-3, torch.Generator().manual_seed(5), 0.2, "mse")
    keeps = [ref_ae.keep_masks(torch.Generator().manual_seed(5), ref_ae.dropout_shapes(model_class, B, 320), 0.2, CPU)]
    losses, grads, end = ref_ae.train_steps(model_class, w, [x], keeps, 0.2, 1e-3, torch.float64)
    assert abs(float(loss) - losses[0]) <= 1e-5 * abs(losses[0])
    after = model.jax_tree()
    for k in end:
        for n in end[k]:
            assert float((after[k][n].detach().double() - end[k][n]).abs().max()) < 1e-6, (k, n)


def test_split_and_order():
    from ae_waveforms_tpu_torch.train.data import draw_split_masks

    ids = data.case_ids(3000, 300)
    np.random.seed(77)
    masks = draw_split_masks(ids, 0.02, 0.01)
    perm = np.random.permutation(int(masks["train"].sum()))
    rows, order = ref_split.train_rows_and_order(ids, 77, 0.02, 0.01)
    assert np.array_equal(rows, np.nonzero(masks["train"])[0]) and np.array_equal(order, perm)


def test_gbt_fit_exact():
    from ae_waveforms_tpu_torch.classify.gbt import fit_gbt_sweep_margins

    rng = np.random.default_rng(0)
    n, F, S = 300, 10, 3
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    w = (rng.random((S, n)) < 0.7).astype(np.float32)
    params = ref_gbt.lhs_params(S, 3)
    hp = {k: torch.tensor([p[k] for p in params], dtype=torch.float32) for k in (
        "learning_rate", "gamma", "min_child_weight", "subsample", "colsample_bytree", "n_estimators", "max_depth")}
    bins = torch.as_tensor(ref_gbt.quantile_bins(X, X, 64))
    depth, trees = 10, 4
    ens, margins = fit_gbt_sweep_margins(bins.int(), y, w, 1, hp["learning_rate"], hp["gamma"],
                                         hp["min_child_weight"], hp["subsample"], hp["colsample_bytree"],
                                         hp["n_estimators"].clamp(max=3), max_depth=depth, n_estimators=trees,
                                         depth_limits=hp["max_depth"])
    heaps, ref_margins = ref_gbt.fit(bins[None].expand(S, -1, -1), torch.as_tensor(y), torch.as_tensor(w), 1,
                                     dict(hp, n_estimators=hp["n_estimators"].clamp(max=3)), depth, trees, 64)
    assert torch.equal(ens.is_split, heaps["is_split"])
    assert torch.equal(torch.where(ens.is_split, ens.feat, 0), heaps["feat"])
    assert torch.equal(torch.where(ens.is_split, ens.thresh, 0), heaps["thresh"])
    assert torch.equal(ens.leaf, heaps["leaf"]) and torch.equal(margins, ref_margins)

