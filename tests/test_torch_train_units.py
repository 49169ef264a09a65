"""The port's training units against the JAX package's, on the same numpy
inputs from seeds.

Tolerances: split masks, subject-id CSVs, batch indices and epoch counts
equal; losses 1e-6 (absolute, and relative for PRD, a percentage in the
hundreds here, where a float32 unit is 1.5e-5); schedules 1e-7 relative
(both float32); optimizers 1e-6 over 20 steps, Ranger rtol 1e-3 and atol
5e-5 (its SMA scalar loses float32 digits at the threshold crossing, as
``tests/test_train.py`` says); dropout by its semantics, since
``jax.random`` cannot be reproduced.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.train import data as jax_data
from ae_waveforms_tpu.train import losses as jax_losses
from ae_waveforms_tpu.train import schedules as jax_schedules
from ae_waveforms_tpu.train.loop import _batched_indices as jax_batched_indices
from ae_waveforms_tpu.train.loop import effective_epochs as jax_effective_epochs
from ae_waveforms_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.models.layers import dropout
from ae_waveforms_tpu_torch.train import data, losses, schedules
from ae_waveforms_tpu_torch.train.loop import _batched_indices, effective_epochs
from ae_waveforms_tpu_torch.train.optimizers import make_optimizer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: with the
    suite's workers sharing the cores, torch's thread pool otherwise waits
    on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _info(n_cases=30, per_case=4):
    ids = np.repeat(np.arange(n_cases) + 1000, per_case).astype(np.float64)
    return np.stack([ids, np.arange(len(ids))], 1)


def _run_split(module, info, root, split_kw, cached):
    dataset_dir, results_dir = os.path.join(root, "data"), os.path.join(root, "results")
    if cached:  # an earlier run's masks in the dataset dir
        os.makedirs(dataset_dir)
        np.random.seed(7)
        for s, m in module.draw_split_masks(info[:, 0], 0.3, 0.2).items():
            np.save(os.path.join(dataset_dir, f"indices_{s}_240101"), m)
    np.random.seed(3)
    masks = module.split_datasets(info, dataset_dir, results_dir, **split_kw)
    files = {f: open(os.path.join(results_dir, f), "rb").read() for f in sorted(os.listdir(results_dir))}
    return masks, files, np.random.random(4)  # the stream after the split


@pytest.mark.parametrize("case", ["fresh", "cached", "nr_train_ids", "regex_rule"])
def test_split_matches_jax(tmp_path, case):
    info = _info()
    split_kw = dict(val_fraction=0.2, test_fraction=0.1)
    if case == "nr_train_ids":
        split_kw["nr_train_ids"] = 9
    if case == "regex_rule":
        split_kw["regex_rule"] = r"10[01]\d"
    got = _run_split(data, info, str(tmp_path / "port"), split_kw, cached=case == "cached")
    want = _run_split(jax_data, info, str(tmp_path / "jax"), split_kw, cached=case == "cached")
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert sorted(got[1]) == sorted(want[1])
    assert all(got[1][f] == want[1][f] for f in want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if case == "regex_rule":
        assert not any(m[info[:, 0] >= 1020].any() for m in got[0])


@pytest.mark.parametrize("n,batch", [(1, 4), (37, 8), (64, 16), (100, 128)])
def test_batched_indices_and_epochs_match_jax(n, batch):
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)
    for g, w in zip(_batched_indices(n, batch, perm), jax_batched_indices(n, batch, perm)):
        np.testing.assert_array_equal(g, w)
    for nr_train_ids in (0, 5):
        kw = dict(batch_size=batch, nr_train_ids=nr_train_ids, epochs=3)
        assert effective_epochs(TrainConfig(**kw), n) == jax_effective_epochs(JaxTrainConfig(**kw), n)


@pytest.mark.parametrize("name", ["mse_loss", "rmse_loss", "smooth_l1_loss", "sample_rmse_loss", "sample_prd_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    pred = (1.5 * rng.standard_normal((6, 320))).astype(np.float32)
    true = rng.standard_normal((6, 320)).astype(np.float32)
    got = getattr(losses, name)(torch.from_numpy(pred), torch.from_numpy(true))
    want = getattr(jax_losses, name)(jnp.asarray(pred), jnp.asarray(true))
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert sorted(losses.LOSSES) == sorted(jax_losses.LOSSES)


@pytest.mark.parametrize("name,kw", [
    ("step_lr", dict(base_lr=1e-3)),
    ("cosine_annealing_warm_restarts", dict(base_lr=1e-3, t_0=7, eta_min=1e-4)),
    ("cosine_annealing_warmup_hard_restarts", dict(base_lr=1e-3, t_0=9, num_warmup_steps=5, min_lr=1e-5)),
    ("cosine_annealing_warmup_hard_restarts", dict(base_lr=3e-3, t_0=13, num_warmup_steps=0, min_lr=1e-5)),
])
def test_schedules_match_jax(name, kw):
    """40 steps through warm-up and restart boundaries, with int32 steps as
    the JAX train step gives them; lambda is exactly 1 at each restart."""
    got_fn, want_fn = getattr(schedules, name)(**kw), getattr(jax_schedules, name)(**kw)
    if name == "step_lr":  # its argument counts plateau events
        got = np.array([got_fn(n) for n in range(40)])
        want = np.array([want_fn(n) for n in range(40)])
    else:
        got = np.array([np.asarray(got_fn(s)) for s in range(40)])
        want = np.array([np.asarray(want_fn(jnp.int32(s))) for s in range(40)])
        assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if "warmup" in name:
        restarts = [s for s in range(kw["num_warmup_steps"], 40) if (s - kw["num_warmup_steps"]) % kw["t_0"] == 0]
        assert all(got[s] == np.float32(kw["base_lr"]) for s in restarts)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("name", ["adam", "adagrad", "adadelta", "sgd", "rmsprop", "ranger"])
def test_optimizer_matches_optax(name, weight_decay):
    """A fixed 20-step sequence of gradients through ``make_optimizer`` of
    both packages; Ranger passes its SMA threshold and three Lookahead
    syncs (k = 6) on the way."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    w0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(20)]
    lr = 1e-2
    jopt = jax_make_optimizer(name, lr, weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in w0.items()}
    jstate = jopt.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(w0[k].copy())) for k in shapes]
    opt = make_optimizer(name, params, lr, weight_decay)
    tol = dict(rtol=1e-3, atol=5e-5) if name == "ranger" else dict(rtol=0, atol=1e-6)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), **tol)


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
def test_dropout_semantics(rate):
    """Inverted dropout as ``models/layers.py::dropout`` of the JAX package:
    identity in eval and at rate 0; in training each value is kept with
    probability 1 - rate (within 3 sigma over 200,000 draws) and scaled by
    1/(1 - rate), from the generator given, never the global one."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 1.5, 200_000).astype(np.float32))
    assert dropout(x, rate, None, train=False) is x
    if rate == 0.0:
        assert dropout(x, rate, None, train=True) is x
        return
    with pytest.raises(ValueError):
        dropout(x, rate, None, train=True)
    state = torch.random.get_rng_state()
    y = dropout(x, rate, torch.Generator().manual_seed(0), train=True)
    assert torch.equal(torch.random.get_rng_state(), state)
    kept = y != 0
    frac = kept.float().mean().item()
    assert abs(frac - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / x.numel())
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    again = dropout(x, rate, torch.Generator().manual_seed(0), train=True)
    assert torch.equal(y, again)
