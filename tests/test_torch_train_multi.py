"""The port's multi-configuration AE trainer (``train/multi.py`` on
``train/stacked.py``) against the JAX package's ``train_ae_multi`` and
against itself.

Against the JAX package, from the JAX package's own init chain injected
into the port (``PRNGKey(seed)`` -> split -> init), dropout 0:

- the LSTM autoencoder at T = 48 (160 beats of 20 cases, B = 16,
  validation every 2 steps, 3 epochs, StepLR with a plateau delay of 1,
  patience 2, lr multipliers 1 and 40, so the second config's learning
  rate halves on plateaus and it stops early): per-config train and
  validation losses rtol 5e-4, atol 5e-5 (the tolerance of
  ``tests/test_torch_train_loop.py``) until a config stops, NaN after it
  in the port (a stopped config drops out; the JAX package trains it on);
  learning rates of every step rtol 1e-6 (float32 on both sides); the
  validation at which each config stops, the stopped flags and
  ``ever_improved`` equal; best validation losses rtol 5e-4;
- the conv autoencoder (T = 320), grouped over latent sizes 3 and 5 with
  per-config splits and lr multipliers, 3 steps: the groups' seeds, lr
  multipliers and run-dir names equal, each run dir's split masks equal,
  losses at the tolerance above.

Against itself, bit for bit on the CPU: S configs against S single-config
runs; a call split by the config cap against the unsplit call; a run
resumed from a mid-run checkpoint against the uninterrupted run.  Run dirs
feed ``main_test``; the CLI trains the seed x lr cross and the latent
groups, then tests one run.
"""

import glob
import os
import types

import jax
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.models.registry import MODEL_REGISTRY as JAX_MODELS
from ae_waveforms_tpu.train import multi as jax_multi
from ae_waveforms_tpu_torch import bridge
from ae_waveforms_tpu_torch.cli.main_ae import autoencoder
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, save_arrays
from ae_waveforms_tpu_torch.train import multi
from ae_waveforms_tpu_torch.train.eval import main_test

RTOL, ATOL = 5e-4, 5e-5
LSTM_KW = dict(model_class="LSTMAutoencoder", latent_size=3, batch_size=16, epochs=3, validation_interval=2,
               split_size_val=0.25, split_size_test=0.25, lr=3e-3, seed=1, plotting=False, dropout=0.0,
               lr_scheduler_val_delay=1, early_stopping_patience=2)
SEEDS, MULTS = [3, 4], [1.0, 40.0]
CONV_KW = dict(LSTM_KW, model_class="LeNet5AutoencoderAvgPool", epochs=1, lr_scheduler_val_delay=0,
               early_stopping_patience=2000)
CONV_CONFIGS = [(3, 3, 1.0), (5, 7, 0.5), (3, 4, 2.0)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(T: int, n: int = 160, cases: int = 20):
    """Beats of length T: an R-like bump plus noise; n / cases a case id.
    A namespace, since ``ArraySet`` holds 320-sample beats only."""
    rng = np.random.default_rng(0)
    t = np.linspace(-1, 2, T)
    waves = (np.exp(-t ** 2 / 0.02)[None] + 0.1 * rng.standard_normal((n, T))).astype(np.float32)
    info = np.stack([np.repeat(np.arange(1, cases + 1), n // cases), np.arange(n)], 1).astype(np.float64)
    return types.SimpleNamespace(waves=waves, features=np.zeros((n, 35), np.float32), info=info)


def _jax_init(model_class: str, latent: int, seeds):
    """The JAX trainer's init: PRNGKey(seed) -> (run key, init key) -> init."""
    keys = jax.vmap(jax.random.PRNGKey)(np.asarray(seeds, np.uint32))
    _, init_keys = jax.vmap(jax.random.split, out_axes=1)(keys)
    init = jax.vmap(lambda k: JAX_MODELS[model_class].init(k, latent, 0.0))(init_keys)
    return jax.tree_util.tree_map(np.asarray, init)


def _spy_jax(monkeypatch, rec):
    """Records each JAX dispatch's learning rates, (steps, S)."""
    real = jax_multi._make_block_multi

    def make(*a, **k):
        run = real(*a, **k)

        def wrapped(*args, do_val):
            out = run(*args, do_val=do_val)
            rec.append(np.asarray(out[11]).transpose(1, 2, 0).reshape(-1, len(SEEDS)))
            return out

        return wrapped

    monkeypatch.setattr(jax_multi, "_make_block_multi", make)


def _spy_port(monkeypatch, rec):
    """Records each port step's learning rates and active configs."""
    real = multi.multi_step

    def step(stacked, optimizer, active, *a):
        rec.append((list(a[3]), list(active)))
        return real(stacked, optimizer, active, *a)

    monkeypatch.setattr(multi, "multi_step", step)


@pytest.fixture(scope="module")
def lstm(tmp_path_factory):
    root = tmp_path_factory.mktemp("lstm")
    arrays = _arrays(48)
    mp = pytest.MonkeyPatch()
    jax_lrs, port_steps = [], []
    try:
        _spy_jax(mp, jax_lrs)
        _spy_port(mp, port_steps)
        jax_cfg = JaxTrainConfig(dataset_dir=str(root / "jd"), results_dir=str(root / "jr"), **LSTM_KW)
        jax_res = jax_multi.train_ae_multi(jax_cfg, SEEDS, arrays=arrays, lr_multipliers=MULTS)
        cfg = TrainConfig(dataset_dir=str(root / "pd"), results_dir=str(root / "pr"), **LSTM_KW)
        port_res = multi.train_ae_multi(cfg, SEEDS, arrays=arrays, lr_multipliers=MULTS, device="cpu",
                                        init_params=_jax_init("LSTMAutoencoder", 3, SEEDS))
    finally:
        mp.undo()
    return dict(jax=jax_res, port=port_res, jax_lrs=np.concatenate(jax_lrs), port_steps=port_steps,
                arrays=arrays, cfg=cfg, root=root)


@pytest.mark.parametrize("what", ["train_losses", "val_losses"])
def test_losses_match_jax_until_a_config_stops(lstm, what):
    got, want = getattr(lstm["port"], what), getattr(lstm["jax"], what)
    assert got.shape == want.shape
    ran = ~np.isnan(got)
    assert ran[:, 0].all() and not ran[:, 1].all()  # the second config stops, the first does not
    for s in range(len(SEEDS)):  # NaN only after a config's last finite entry
        assert ran[: ran[:, s].sum(), s].all()
    np.testing.assert_allclose(got[ran], want[ran], rtol=RTOL, atol=ATOL)


def test_learning_rates_match_jax(lstm):
    """Every step's learning rate of every config that still trains: the
    multipliers and the plateau halvings (the second config's rate moves)."""
    port = np.array([lrs for lrs, _ in lstm["port_steps"]])
    active = np.zeros_like(port, dtype=bool)
    for i, (_, act) in enumerate(lstm["port_steps"]):
        active[i, act] = True
    want = lstm["jax_lrs"]
    assert port.shape == want.shape
    np.testing.assert_allclose(port[active], want[active], rtol=1e-6)
    assert len(set(port[active[:, 1], 1])) > 1


def test_stop_validations_match_jax(lstm):
    """The validation after which each config stops: the port's last one,
    the JAX package's from its validation losses by the counters' rule
    (improve below the best; stop at ``patience`` validations without)."""
    port, ref = lstm["port"], lstm["jax"]
    np.testing.assert_array_equal(port.stopped, ref.stopped)
    np.testing.assert_array_equal(port.ever_improved, ref.ever_improved)
    np.testing.assert_allclose(port.best_val, ref.best_val, rtol=RTOL)
    for s in range(len(SEEDS)):
        best, ctr, stop = np.inf, 0, None
        for i, v in enumerate(ref.val_losses[:, s]):
            if v < best:
                best, ctr = v, 0
            else:
                ctr += 1
                if ctr >= LSTM_KW["early_stopping_patience"]:
                    stop = i
                    break
        ran = int((~np.isnan(port.val_losses[:, s])).sum())
        assert (stop is None and ran == len(ref.val_losses)) or ran == stop + 1


def test_lr_multipliers_match_jax(lstm):
    np.testing.assert_array_equal(lstm["port"].lr_multipliers, lstm["jax"].lr_multipliers)


@pytest.fixture(scope="module")
def conv(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv")
    arrays = _arrays(320)
    kw = dict(arrays=arrays, max_steps=3, per_config_splits=True, save_runs=True)
    jax_cfg = JaxTrainConfig(dataset_dir=str(root / "jd"), results_dir=str(root / "jr"), **CONV_KW)
    jax_out = jax_multi.train_ae_multi_grouped(jax_cfg, CONV_CONFIGS, **kw)
    cfg = TrainConfig(dataset_dir=str(root / "pd"), results_dir=str(root / "pr"), **CONV_KW)
    grouped = multi.train_ae_multi_grouped(cfg, CONV_CONFIGS, device="cpu", **kw)
    # each group from the JAX package's init of its seeds
    from_init = {}
    for latent, res in jax_out.items():
        from_init[latent] = multi.train_ae_multi(
            cfg.replace(latent_size=latent, results_dir=str(root / f"pi{latent}")), res.seeds,
            lr_multipliers=res.lr_multipliers, device="cpu",
            init_params=_jax_init(cfg.model_class, latent, res.seeds), **kw)
    return dict(jax=jax_out, port=grouped, from_init=from_init)


def test_grouped_latents_match_jax(conv):
    assert sorted(conv["port"]) == sorted(conv["jax"]) == [3, 5]
    for latent, want in conv["jax"].items():
        got = conv["port"][latent]
        assert got.seeds == want.seeds
        np.testing.assert_array_equal(got.lr_multipliers, want.lr_multipliers)
        name = lambda d: os.path.basename(d).split("-", 4)[-1]  # noqa: E731  (the stamp left out)
        assert [name(d) for d in got.run_dirs] == [name(d) for d in want.run_dirs]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_per_config_split_membership_matches_jax(conv, split):
    for latent, want in conv["jax"].items():
        for got_dir, want_dir in zip(conv["port"][latent].run_dirs, want.run_dirs):
            masks = [np.load(glob.glob(os.path.join(d, f"indices_{split}_*.npy"))[0]) for d in (got_dir, want_dir)]
            np.testing.assert_array_equal(*masks)


@pytest.mark.parametrize("what", ["train_losses", "val_losses"])
def test_conv_losses_match_jax(conv, what):
    for latent, want in conv["jax"].items():
        got = getattr(conv["from_init"][latent], what)
        assert got.shape == getattr(want, what).shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, getattr(want, what), rtol=RTOL, atol=ATOL)


def _cfg(tmp_path, name, **kw):
    return TrainConfig(dataset_dir=str(tmp_path / f"{name}_data"), results_dir=str(tmp_path / name),
                       **{**LSTM_KW, "epochs": 2, "dropout": 0.1, **kw})


def _same(a, b):
    for what in ("train_losses", "val_losses", "best_val", "stopped", "ever_improved"):
        np.testing.assert_array_equal(getattr(a, what), getattr(b, what))
    for x, y in zip(jax.tree_util.tree_leaves(a.best_params), jax.tree_util.tree_leaves(b.best_params)):
        np.testing.assert_array_equal(x, y)


def test_stacked_configs_equal_single_config_runs(tmp_path):
    """Three configs together and each alone, dropout 0.1: bit for bit."""
    arrays = _arrays(48)
    both = multi.train_ae_multi(_cfg(tmp_path, "m"), [3, 4, 5], arrays=arrays, lr_multipliers=[1, 2, 0.5],
                                max_steps=8, device="cpu")
    for i, (seed, mult) in enumerate(zip([3, 4, 5], [1, 2, 0.5])):
        one = multi.train_ae_multi(_cfg(tmp_path, f"s{seed}"), [seed], arrays=arrays, lr_multipliers=[mult],
                                   max_steps=8, device="cpu")
        _same(one, multi._merge_multi_results([_pick(both, i)]))


def _pick(res, i):
    return multi.MultiTrainResult(
        seeds=[res.seeds[i]], best_params=multi.stack_trees([res.params_for(i)]), best_val=res.best_val[i:i + 1],
        ever_improved=res.ever_improved[i:i + 1], stopped=res.stopped[i:i + 1],
        train_losses=res.train_losses[:, i:i + 1], val_losses=res.val_losses[:, i:i + 1],
        lr_multipliers=res.lr_multipliers[i:i + 1])


def test_cap_split_call_equals_unsplit_call(tmp_path):
    arrays = _arrays(48)
    whole = multi.train_ae_multi(_cfg(tmp_path, "w"), [3, 4, 5], arrays=arrays, max_steps=6, device="cpu")
    split = multi.train_ae_multi(_cfg(tmp_path, "p"), [3, 4, 5], arrays=arrays, max_steps=6, device="cpu",
                                 max_config_chunk=2)
    _same(split, whole)


def test_config_cap_counts_what_the_port_holds():
    """``core/hbm.py``: the cap is the budget (free bytes x safety, less the
    shared bytes and one working set) over a config's own bytes, at least
    1; a config's bytes are its 5 parameter copies and its own rows; remat
    shrinks the working set, and the validation pass's counts where it is
    the larger."""
    from ae_waveforms_tpu_torch.core import hbm

    per = hbm.train_block_hbm_bytes_per_config(100, 20, 320, 64, (128, 64, 64), 1000)
    assert per == 4 * (5 * 1000 + 120 * 320)
    ws = hbm.recurrent_working_set_bytes(320, 64, (128, 64, 64))
    assert hbm.recurrent_working_set_bytes(320, 64, (128, 64, 64), remat_chunk=20) < ws
    assert hbm.recurrent_working_set_bytes(320, 64, (128, 64, 64), n_val=10_000) > ws
    free = 10 * 2**30
    cap = hbm.seed_axis_cap(100, 20, 320, 64, (128, 64, 64), 1000, shared_bytes=2**20, free_bytes=free)
    assert cap == int((free * hbm.SAFETY - 2**20 - hbm.recurrent_working_set_bytes(320, 64, (128, 64, 64), 0, 20))
                      // per)
    assert hbm.seed_axis_cap(100, 20, 320, 64, (128, 64, 64), 1000, free_bytes=0) == 1


def test_resume_is_bit_identical(tmp_path):
    arrays = _arrays(48)
    cfg = _cfg(tmp_path, "r")
    full = multi.train_ae_multi(cfg, SEEDS, arrays=arrays, max_steps=12, results_dir=str(tmp_path / "full"),
                                device="cpu")
    part = multi.train_ae_multi(cfg, SEEDS, arrays=arrays, max_steps=6, results_dir=str(tmp_path / "ck"),
                                checkpoint_every=1, device="cpu")
    assert os.path.exists(tmp_path / "ck" / "multi_checkpoint_d3.npz")
    resumed = multi.train_ae_multi(cfg, SEEDS, arrays=arrays, max_steps=12, results_dir=str(tmp_path / "ck"),
                                   checkpoint_every=1, resume_dir=str(tmp_path / "ck"), device="cpu")
    _same(resumed, full)
    assert len(part.train_losses) < len(full.train_losses)
    np.testing.assert_array_equal(part.train_losses, full.train_losses[: len(part.train_losses)])
    with pytest.raises(ValueError, match="refusing to resume"):
        multi.train_ae_multi(cfg, [3, 5], arrays=arrays, max_steps=12, results_dir=str(tmp_path / "ck"),
                             resume_dir=str(tmp_path / "ck"), device="cpu")


def test_configs_that_all_stop_mid_dispatch_end_the_run(tmp_path):
    """At learning rate 0 no validation after the first improves, so with
    patience 1 both configs stop at the second; the dispatch's remaining
    steps train nothing (NaN) and the run ends after it."""
    res = multi.train_ae_multi(_cfg(tmp_path, "stop", lr=0.0, early_stopping_patience=1), SEEDS, arrays=_arrays(48),
                               device="cpu")
    assert res.stopped.all() and res.ever_improved.all()
    assert np.isnan(res.train_losses[-1]).all() and np.isfinite(res.val_losses[:2]).all()
    assert np.isnan(res.val_losses[2:]).all()


def test_save_runs_feed_main_test(tmp_path):
    """Each config's run dir (duplicate configs included) holds what the
    port's ``main_test`` reads; its test pass uses that config's params."""
    arrays = _arrays(48)
    cfg = _cfg(tmp_path, "runs")
    res = multi.train_ae_multi(cfg, [3, 3, 4], arrays=arrays, max_steps=4, save_runs=True, device="cpu")
    assert len(set(res.run_dirs)) == 3
    latents = []
    for i, run_dir in enumerate(res.run_dirs):
        _, (loss, *_), _, z = main_test(cfg.replace(mode="test", trained_model=os.path.basename(run_dir)),
                                        arrays=arrays, device="cpu")
        ref = main_test(cfg.replace(mode="test", trained_model=os.path.basename(run_dir)), arrays=arrays,
                        params=res.params_for(i), device="cpu")[3]
        assert np.isfinite(loss)
        np.testing.assert_array_equal(z, ref)
        latents.append(z)
    np.testing.assert_array_equal(latents[0], latents[1])  # seed 3 twice
    assert not np.array_equal(latents[0], latents[2])


def test_stacked_trees_cross_the_bridge():
    """A JAX-style tree with a leading config axis -> the port's tensors ->
    back, and -> per-config trees -> stacked again."""
    tree = _jax_init("LSTMAutoencoder", 3, [3, 4])
    back = bridge.tree_to_numpy(bridge.tree_from_numpy(tree, device="cpu"))
    for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(x, y)
    again = multi.stack_trees(multi.unstack_tree(tree))
    for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(x, y)


def test_cli_trains_the_cross_and_the_latent_groups(tmp_path, capsys):
    rng = np.random.default_rng(0)
    n = 120
    info = np.stack([np.repeat(np.arange(20) + 100, n // 20), np.arange(n)], 1).astype(np.float64)
    data = str(tmp_path / "data")
    save_arrays(ArraySet(rng.standard_normal((n, 320)).astype(np.float32), np.zeros((n, 35), np.float32), info),
                data)
    args = ["--dataset_dir", data, "--results_dir", str(tmp_path / "res"), "--model_class",
            "LeNet5AutoencoderAvgPool", "--batch_size", "16", "--epochs", "1", "--validation_interval", "3",
            "--split_size_val", "0.25", "--split_size_test", "0.25", "--plotting", "", "--device", "cpu"]
    runs = autoencoder(["-m", "train", *args, "--latent_size", "3", "--seeds", "3,4", "--lr_sweep", "1,0.25"])
    names = sorted(os.path.basename(d) for d in runs)
    assert [n.split("-", 4)[-1] for n in names] == ["d3-s3-lr0.25", "d3-s3-lr1", "d3-s4-lr0.25", "d3-s4-lr1"]
    grouped = autoencoder(["-m", "train", *args, "--latent_sizes", "3,5", "--seeds", "3"])
    assert [os.path.basename(d).split("-", 4)[-1] for d in grouped] == ["d3-s3", "d5-s3"]
    assert "Training done (latent 5, seed 3" in capsys.readouterr().out
    out = autoencoder(["-m", "test", *args, "--latent_size", "5", "--trained_model", os.path.basename(grouped[1])])
    assert np.isfinite(out[0])
