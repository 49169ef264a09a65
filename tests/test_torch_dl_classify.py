"""The port's DL classifier (``models/lstm_classifier.py``,
``classify/dl.py``), its stratified split (``classify/split.py``) and the
MLP head (``classify/mlp.py``) against the JAX package and scikit-learn,
on the CPU at small sizes (beats of 32 to 48 samples, tens of rows).

Tolerances:
- the classifier from one injected init: eval and train forward (rate 0)
  1e-6 absolute, the BatchNorm state update 1e-6, one BCE gradient 5e-4 of
  each leaf's largest |g| plus 1e-7 against ``jax.grad`` (float32 sums of
  40 steps' terms that nearly cancel in the attention's weight and the last
  LSTM's biases: 2e-4 and 1.3e-4 here, the rest under 4e-5); ``remat_chunk``
  against the plain forward, gradients 1e-6 of each leaf's largest plus
  1e-7 (the 1e-7: the attention's bias, whose gradient is 0 but for
  rounding, since a softmax ignores a shift);
- the sweep (2 sizes x 2 seeds, 3 epochs, the JAX init chain's params in
  the port, dropout off on both sides): seed rows, splits and epoch
  permutations equal; per-seed test AUCs within 2e-3 (6.25e-4 here, one
  of the 40 x 40 test pairs: after 3 epochs the probabilities sit within a
  few float32 ulps of each other, and float32 training on either side
  orders such near-ties differently); CSV files equal in schema and row
  keys;
- the split: equal to sklearn's ``train_test_split(..., stratify=y)`` row
  for row, ties in its class counts included;
- stacked seeds against single-seed runs, a cap-split call against the
  unsplit one, the never-improved fallback: bit for bit; stacked training
  with ``remat_chunk`` against without, probabilities 1e-5;
- the MLP head: ``fit_mlp`` from the JAX init, probabilities 1e-5;
  ``fit_mlp_multi`` against per-seed ``fit_mlp``, probabilities 1e-5 (a
  batched matmul over the seeds against one matmul a seed).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from ae_waveforms_tpu.classify import dl as jax_dl
from ae_waveforms_tpu.classify import mlp as jax_mlp
from ae_waveforms_tpu.models import lstm_classifier as jax_lc
from ae_waveforms_tpu.train.checkpoint import load_state as jax_load_state
from ae_waveforms_tpu_torch import bridge
from ae_waveforms_tpu_torch.classify import dl, mlp
from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier
from ae_waveforms_tpu_torch.classify.harness import evaluate_combined_model_auc, roc_auc_score
from ae_waveforms_tpu_torch.classify.split import train_test_split
from ae_waveforms_tpu_torch.cli import classify as cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(seed: int):
    """The JAX harness's init of a seed: PRNGKey(seed) -> (init, run) keys."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return _np(jax_lc.init(k_init))


def _beats(n: int, T: int, shift: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.linspace(-1, 2, T)
    return (np.exp(-t ** 2 / 0.02)[None] * (1 + shift) + 0.3 * rng.standard_normal((n, T))).astype(np.float32)


# -- the classifier -------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_init():
    params, _ = jax_init(0)
    rng = np.random.default_rng(1)
    state = {"bn_mean": (0.1 * rng.standard_normal(64)).astype(np.float32),
             "bn_var": (1 + rng.random(64)).astype(np.float32)}
    x = rng.standard_normal((8, 40, 1)).astype(np.float32)
    y = np.r_[np.zeros(4), np.ones(4)].astype(np.float32)
    return params, state, x, y


def _port_grads(params, state, x, y, remat_chunk=None):
    model = bridge.classifier_from_numpy(params, state, device="cpu").train()
    probs = model(torch.from_numpy(x), 0.0, None, remat_chunk)[:, 0].clamp(1e-7, 1 - 1e-7)
    yt = torch.from_numpy(y)
    (-(yt * torch.log(probs) + (1 - yt) * torch.log(1 - probs))).mean().backward()
    return bridge.tree_to_numpy({k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
                                  for k, v in model.jax_tree().items()}), model


def test_classifier_eval_forward_matches_jax(one_init):
    params, state, x, _ = one_init
    model = bridge.classifier_from_numpy(params, state, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want, _ = jax_lc.forward(params, state, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    back_params, back_state = bridge.classifier_to_numpy(model)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)), jax.tree_util.tree_leaves((back_params, back_state))):
        np.testing.assert_array_equal(a, b)


def test_classifier_train_forward_and_state_match_jax(one_init):
    params, state, x, _ = one_init
    model = bridge.classifier_from_numpy(params, state, device="cpu").train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), 0.0, None).numpy()
    want, new_state = jax_lc.forward(params, state, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(1), rate=0.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    for k in ("bn_mean", "bn_var"):
        np.testing.assert_allclose(getattr(model, k).numpy(), np.asarray(new_state[k]), rtol=0, atol=1e-6)


def test_classifier_bce_gradient_matches_jax(one_init):
    params, state, x, y = one_init

    def loss(p):
        probs, _ = jax_lc.forward(p, state, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(1), rate=0.0)
        probs = jnp.clip(probs[:, 0], 1e-7, 1 - 1e-7)
        return jnp.mean(-(y * jnp.log(probs) + (1 - y) * jnp.log(1 - probs)))

    want = jax.tree_util.tree_leaves(_np(jax.grad(loss)(params)))
    got = jax.tree_util.tree_leaves(_port_grads(params, state, x, y)[0])
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 5e-4 * np.abs(w).max() + 1e-7


def test_remat_chunk_keeps_the_gradients(one_init):
    params, state, x, y = one_init
    plain = jax.tree_util.tree_leaves(_port_grads(params, state, x, y)[0])
    remat = jax.tree_util.tree_leaves(_port_grads(params, state, x, y, remat_chunk=7)[0])
    for g, w in zip(remat, plain):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max() + 1e-7


# -- the split ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n_neg,n_pos", [(2, 2), (2, 9), (3, 7), (5, 5), (10, 41), (40, 40), (81, 19), (200, 199),
                                         (999, 1000)])
def test_split_equals_sklearn(n_neg, n_pos):
    """Every seed of 8, with shuffled labels: 0.2 * n rows often leave the
    two classes equal remainders, which sklearn breaks from its stream.
    Where sklearn refuses (a side with fewer rows than classes), so does
    the port."""
    X = np.arange(n_neg + n_pos)
    for seed in range(8):
        y = np.r_[np.zeros(n_neg), np.ones(n_pos)]
        np.random.default_rng(seed).shuffle(y)
        try:
            want = sk_split(X, y, test_size=0.2, stratify=y, random_state=seed)
        except ValueError:
            with pytest.raises(ValueError):
                train_test_split(X, y, test_size=0.2, stratify=y, random_state=seed)
            continue
        got = train_test_split(X, y, test_size=0.2, stratify=y, random_state=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_combined_model_auc_uses_the_same_rows_as_sklearn():
    """``evaluate_combined_model_auc`` gives the AUC that sklearn's split
    gave it before the port had its own."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((120, 5)).astype(np.float32)
    y = (X[:, 0] + rng.standard_normal(120) > 0).astype(float)
    params = dict(max_depth=3, n_estimators=5, learning_rate=0.3)
    Xtr, Xva, ytr, yva = sk_split(X, y, test_size=0.2, random_state=4, stratify=y)
    m = GBTClassifier(**params, random_state=4, device="cpu").fit(Xtr, ytr)
    want = roc_auc_score(yva, m.predict_proba(Xva)[:, 1])
    assert evaluate_combined_model_auc(X, y, params, 4, device="cpu") == want


# -- stacked against single ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seeds_data():
    rng = np.random.default_rng(0)
    S, n, m, T = 3, 40, 12, 32
    Xs = rng.standard_normal((S, n, T, 1)).astype(np.float32)
    ys = (rng.random((S, n)) > 0.5).astype(np.float32)
    Xvs = rng.standard_normal((S, m, T, 1)).astype(np.float32)
    yvs = np.tile(np.r_[np.zeros(6), np.ones(6)], (S, 1))
    return Xs, ys, Xvs, yvs


def _equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_stacked_seeds_equal_single_seed_runs(seeds_data):
    Xs, ys, Xvs, yvs = seeds_data
    kw = dict(num_epochs=3, batch_size=16, device="cpu")
    multi = dl.train_classifier_multi(Xs, ys, Xvs, yvs, [0, 1, 2], **kw)
    for i in range(3):
        _equal(multi[i], dl.train_classifier(Xs[i], ys[i], Xvs[i], yvs[i], i, **kw))
    _equal(dl.train_classifier_multi(Xs, ys, Xvs, yvs, [0, 1, 2], max_seed_chunk=2, **kw), multi)


def test_stacked_remat_trains_as_the_plain_path(seeds_data):
    """``remat_chunk`` in the stacked trainer, where each seed's weights
    are swapped into the template: the trained models' probabilities equal
    the plain path's within 1e-5 (their weights may part by up to 3e-4 where
    a gradient is rounding noise, as the attention's bias, which Adam
    moves by about lr a step either way), and training moved them from
    their init by far more."""
    Xs, ys, Xvs, yvs = seeds_data
    kw = dict(num_epochs=3, batch_size=16, device="cpu", min_delta=-1.0, dropout_rate=0.0)
    plain = dl.predict(dl.train_classifier_multi(Xs[:2], ys[:2], Xvs[:2], yvs[:2], [0, 1], **kw), Xvs[0], device="cpu")
    remat = dl.predict(dl.train_classifier_multi(Xs[:2], ys[:2], Xvs[:2], yvs[:2], [0, 1], remat_chunk=7, **kw),
                       Xvs[0], device="cpu")
    init = dl.predict([bridge.classifier_to_numpy(dl.LSTMClassifier(generator=torch.Generator().manual_seed(s),
                                                                     device="cpu")) for s in (0, 1)], Xvs[0],
                      device="cpu")
    np.testing.assert_allclose(remat, plain, rtol=0, atol=1e-5)
    assert np.abs(plain - init).max() > 1e-4


def test_never_improved_seed_keeps_its_params_at_its_stopping_epoch(seeds_data):
    """A seed whose AUC never clears ``min_delta`` stops at ``patience``
    epochs and keeps its final params: those of a 2-epoch run (the JAX
    package's vectorized path would keep training it to its block's end)."""
    Xs, ys, Xvs, yvs = seeds_data
    kw = dict(batch_size=16, device="cpu", min_delta=2.0)
    stopped = dl.train_classifier_multi(Xs[:2], ys[:2], Xvs[:2], yvs[:2], [0, 1], num_epochs=6, patience=2, **kw)
    two = dl.train_classifier_multi(Xs[:2], ys[:2], Xvs[:2], yvs[:2], [0, 1], num_epochs=2, patience=50, **kw)
    _equal(stopped, two)


# -- the sweep against the JAX package ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    control, sick = _beats(80, 48, 0.0, 1), _beats(80, 48, 0.4, 2)
    kw = dict(sizes=(20, 40), n_seeds=2, num_epochs=3, vectorized=True, seed_chunk=2, test_size=40)
    rec = {"jax": {"data": [], "idx": []}, "port": {"data": [], "idx": []}}
    mp = pytest.MonkeyPatch()
    try:
        forward = jax_lc.forward
        mp.setattr(jax_lc, "forward", lambda *a, **k: forward(*a, **{**k, "rate": 0.0}))
        jax.clear_caches()
        real_multi, real_block = jax_dl.train_classifier_multi, jax_dl._get_epoch_block_multi

        def jax_multi(Xs, ys, Xvs, yvs, seeds, **k):
            rec["jax"]["data"].append((Xs, ys, Xvs, yvs, list(seeds)))
            return real_multi(Xs, ys, Xvs, yvs, seeds, **k)

        def jax_block(remat):
            run = real_block(remat)

            def wrapped(*args):
                rec["jax"]["idx"].append(np.asarray(args[13]).transpose(1, 2, 0, 3).reshape(-1, *args[13].shape[::3]))
                return run(*args)

            return wrapped

        mp.setattr(jax_dl, "train_classifier_multi", jax_multi)
        mp.setattr(jax_dl, "_get_epoch_block_multi", jax_block)
        jax_out = jax_dl.dl_size_seed_sweep(control, sick, out_dir=str(root / "jax"), **kw)
        mp.undo()
        jax.clear_caches()

        real_pmulti, real_step = dl.train_classifier_multi, dl.stacked_step

        def port_multi(Xs, ys, Xvs, yvs, seeds, **k):
            rec["port"]["data"].append((Xs, ys, Xvs, yvs, list(seeds)))
            return real_pmulti(Xs, ys, Xvs, yvs, seeds, **k)

        def port_step(stacked, optimizer, active, x, y, idx, *a):
            rec["port"]["idx"].append(idx.numpy().copy())
            return real_step(stacked, optimizer, active, x, y, idx, *a)

        mp.setattr(dl, "train_classifier_multi", port_multi)
        mp.setattr(dl, "stacked_step", port_step)
        port_out = dl.dl_size_seed_sweep(control, sick, out_dir=str(root / "port"), device="cpu", init=jax_init,
                                         dropout_rate=0.0, **kw)
    finally:
        mp.undo()
    return dict(jax=jax_out, port=port_out, rec=rec, root=root)


def test_sweep_seed_rows_and_splits_match_jax(sweeps):
    got, want = sweeps["rec"]["port"]["data"], sweeps["rec"]["jax"]["data"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[4] == w[4] == [0, 1]
        for a, b in zip(g[:4], w[:4]):
            np.testing.assert_array_equal(a, b)


def test_sweep_epoch_permutations_match_jax(sweeps):
    got = np.stack(sweeps["rec"]["port"]["idx"])
    want = np.concatenate(sweeps["rec"]["jax"]["idx"])
    np.testing.assert_array_equal(got, want)


def test_sweep_test_aucs_match_jax(sweeps):
    for g, w in zip(sweeps["port"], sweeps["jax"]):
        assert g["size"] == w["size"]
        np.testing.assert_allclose(g["aucs"], w["aucs"], rtol=0, atol=2e-3)
    assert sweeps["port"][1]["median_auc"] > 0.7  # the classes part


def test_sweep_csvs_match_jax_in_schema_and_keys(sweeps):
    root = sweeps["root"]
    files = {k: sorted(os.path.relpath(os.path.join(d, f), root / k) for d, _, fs in os.walk(root / k) for f in fs)
             for k in ("jax", "port")}
    assert files["jax"] == files["port"] and "summary_auc_stats.csv" in files["port"]
    for rel in files["port"]:
        rows = {}
        for k in ("jax", "port"):
            with open(root / k / rel) as f:
                rows[k] = list(csv.reader(f))
        assert rows["port"][0] == rows["jax"][0]
        assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]


# -- the CLI --------------------------------------------------------------------------------------------------------


def test_cli_deep_runs_and_saves_models_both_packages_read(tmp_path):
    d = str(tmp_path)
    waves = np.concatenate([_beats(280, 32, 0.0, 1), _beats(280, 32, 0.4, 2)])  # 250 of each class are the test tail
    ids = np.repeat(np.arange(8) + 1000, 70)
    np.save(os.path.join(d, "np_waves.npy"), waves)
    np.save(os.path.join(d, "np_info.npy"), np.stack([ids, np.arange(560)], 1).astype(np.float64))
    for name, part in (("controls.csv", ids[:280:70]), ("hypopotassium.csv", ids[280::70])):
        with open(os.path.join(d, name), "w") as f:
            f.write("idx,caseid\n" + "".join(f"{i},{c}\n" for i, c in enumerate(part)))
    summary = cli.main(["deep", "--data", d, "--sizes", "10", "--seeds", "2", "--epochs", "2", "--vectorized",
                        "--save_models", "--remat_chunk", "8", "--device", "cpu"])
    assert [r["size"] for r in summary] == [10] and len(summary[0]["aucs"]) == 2
    out = os.path.join(d, "2_hypopotassium", "size_10")
    assert {"aucs_size_10.csv", "model_seed_0.npz", "model_seed_1.npz"} <= set(os.listdir(out))
    params, state = jax_init(0)
    saved = jax_load_state(os.path.join(out, "model_seed_1.npz"), {"params": params, "state": state})
    model = bridge.classifier_from_numpy(saved["params"], saved["state"], device="cpu")
    with torch.no_grad():
        port = model(torch.from_numpy(waves[:, :, None])).numpy()
    want, _ = jax_lc.forward(saved["params"], saved["state"], jnp.asarray(waves[:, :, None]), train=False)
    np.testing.assert_allclose(port, np.asarray(want), rtol=0, atol=1e-6)


# -- the MLP head ---------------------------------------------------------------------------------------------------


def _task(n=300, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = ((X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.standard_normal(n)) > 0).astype(np.float32)
    return X, y


def test_fit_mlp_matches_jax_from_one_init():
    X, y = _task()
    w = (np.random.default_rng(1).random(len(y)) > 0.3).astype(np.float32)
    init = _np(jax_mlp._init(jax.random.PRNGKey(3), X.shape[1]))
    want = jax_mlp.fit_mlp(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jax.random.PRNGKey(3), steps=100)
    got = mlp.fit_mlp(X, y, w, None, steps=100, init=bridge.tree_to_numpy(bridge.tree_from_numpy(init, device="cpu")),
                      device="cpu")
    np.testing.assert_allclose(mlp.predict_mlp(got, X).numpy(), np.asarray(jax_mlp.predict_mlp(want, jnp.asarray(X))),
                               rtol=0, atol=1e-5)


def test_fit_mlp_multi_equals_per_seed_fits():
    X, y = _task(seed=1)
    W = np.ones((3, len(y)), np.float32)
    W[1, ::3] = 0.0
    W[2, 150:] = 0.0
    multi = mlp.fit_mlp_multi(X, y, W, [torch.Generator().manual_seed(s) for s in range(3)], steps=50, device="cpu")
    probs = mlp.predict_mlp(multi, X).numpy()
    for s in range(3):
        single = mlp.fit_mlp(X, y, W[s], torch.Generator().manual_seed(s), steps=50, device="cpu")
        np.testing.assert_allclose(probs[s], mlp.predict_mlp(single, X).numpy(), rtol=0, atol=1e-5)
    clf = mlp.MLPClassifier(random_state=0, device="cpu").fit(X[:200], y[:200])
    assert roc_auc_score(y[200:], clf.predict_proba(X[200:])[:, 1]) > 0.9

