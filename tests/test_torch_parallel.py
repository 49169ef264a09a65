"""The port's sharded paths over several gloo ranks on the CPU
(``ae_waveforms_tpu_torch.parallel``): the tensor-parallel pair against the
JAX package's on its 8 virtual CPU devices, and the sharded AE train step
against the unsharded port (which earlier tests hold to the JAX package).

Each module fixture spawns one set of ranks (``dryrun.run_sharded``) that
runs several workloads; the unsharded runs are the same workload functions
with ``mesh=None`` in this process."""

import jax
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.parallel.mesh import data_mesh as jax_mesh
from ae_waveforms_tpu.parallel.tp import mlp_forward_tp, shard_mlp_params, tp_train_step
from ae_waveforms_tpu_torch.parallel import dryrun
from ae_waveforms_tpu_torch.parallel.mesh import block

D_IN, HIDDEN, N = 12, 32, 16


def _tp_data(seed):
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.standard_normal((D_IN, HIDDEN)) * 0.3).astype(np.float32), "b1": np.zeros(HIDDEN, np.float32),
              "w2": (rng.standard_normal((HIDDEN, 1)) * 0.3).astype(np.float32), "b2": np.zeros(1, np.float32)}
    return params, rng.standard_normal((N, D_IN)).astype(np.float32), rng.standard_normal(N).astype(np.float32)


TP_GRIDS = {(2, 2): 0, (1, 4): 1}  # (data, model) -> the job's seed
AE_CASES = {"lstm": dict(model_class="LSTMAutoencoder", latent=4, n_rows=40, batch=16, seq_len=32),
            "conv": dict(model_class="LeNet5AutoencoderAvgPool", latent=4, n_rows=40, batch=16, seq_len=320),
            "lstm-rmse": dict(model_class="LSTMAutoencoder", latent=4, n_rows=40, batch=16, seq_len=32, loss="rmse")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as a CPU rank has: the references run beside
    spawned ranks and other test workers, and oneDNN's convolutions sum in
    an order that depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def four_ranks():
    """4 ranks: the pair on the (2, 2) and (1, 4) grids, the AE steps on (2, 2)."""
    jobs = [("tp", model, dict(zip(("params", "x", "y"), _tp_data(seed)))) for (_, model), seed in TP_GRIDS.items()]
    jobs += [("ae", 2, AE_CASES[k]) for k in ("lstm", "conv")]
    return dryrun.run_sharded(jobs, ["cpu"] * 4, "gloo", timeout_s=240)["results"]


@pytest.fixture(scope="module")
def two_ranks():
    """2 ranks: the AE steps with the batch split in two."""
    return dryrun.run_sharded([("ae", 1, AE_CASES[k]) for k in AE_CASES], ["cpu"] * 2, "gloo",
                              timeout_s=240)["results"]


@pytest.mark.parametrize("grid", list(TP_GRIDS))
def test_tp_forward_matches_jax(four_ranks, grid):
    params, x, _ = _tp_data(TP_GRIDS[grid])
    mesh = jax_mesh(4, model_parallel=grid[1])
    want = np.asarray(mlp_forward_tp(shard_mlp_params(jax.tree_util.tree_map(jax.numpy.asarray, params), mesh),
                                     jax.numpy.asarray(x), mesh))
    got = four_ranks[list(TP_GRIDS).index(grid)]
    np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)
    # the hidden axis is split over the model ranks: each holds HIDDEN / model columns of W1
    assert (D_IN, HIDDEN // grid[1]) in got["shard_shapes"] and (HIDDEN // grid[1], 1) in got["shard_shapes"]


@pytest.mark.parametrize("grid", list(TP_GRIDS))
def test_tp_train_step_matches_jax(four_ranks, grid):
    params, x, y = _tp_data(TP_GRIDS[grid])
    mesh = jax_mesh(4, model_parallel=grid[1])
    jparams = shard_mlp_params(jax.tree_util.tree_map(jax.numpy.asarray, params), mesh)
    want_p, want_loss = tp_train_step(jparams, jax.numpy.asarray(x), jax.numpy.asarray(y), 0.1, mesh)
    got = four_ranks[list(TP_GRIDS).index(grid)]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got["params"][k], np.asarray(want_p[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,multiple", [(10, 4), (8, 4), (3, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    from ae_waveforms_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from ae_waveforms_tpu_torch.parallel.mesh import pad_to_multiple

    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, want = pad_to_multiple(x, multiple), jax_pad(x, multiple)
    assert got[1] == want[1] == n and got[0].shape[0] % multiple == 0
    np.testing.assert_array_equal(got[0], want[0])


def test_block_split_is_contiguous_and_uneven():
    assert [block(10, 4, i) for i in range(4)] == [slice(0, 3), slice(3, 6), slice(6, 8), slice(8, 10)]
    assert [block(2, 4, i) for i in range(4)] == [slice(0, 1), slice(1, 2), slice(2, 2), slice(2, 2)]


def _assert_ae_close(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["val"], want["val"], rtol=2e-5, atol=2e-6)
    for layer in want["params"]:
        for k in want["params"][layer]:
            np.testing.assert_allclose(got["params"][layer][k], want["params"][layer][k], rtol=2e-4, atol=2e-5,
                                       err_msg=f"{layer}.{k}")


@pytest.mark.parametrize("case", list(AE_CASES))
def test_sharded_ae_step_matches_unsharded_on_two_ranks(two_ranks, case):
    """An epoch of 3 steps (the last batch holds 8 of 16 rows) with dropout
    0.2 and validation: the batch split over 2 ranks against one device."""
    got = two_ranks[list(AE_CASES).index(case)]
    want = dryrun.ae_steps("cpu", None, **AE_CASES[case])
    assert len(want["losses"]) == 3
    _assert_ae_close(got, want)


@pytest.mark.parametrize("case", ["lstm", "conv"])
def test_sharded_ae_step_matches_unsharded_on_a_2x2_grid(four_ranks, case):
    """The model replicated over the model axis: its ranks compute the same
    rows, the gradients are summed over the data axis alone."""
    got = four_ranks[len(TP_GRIDS) + ["lstm", "conv"].index(case)]
    _assert_ae_close(got, dryrun.ae_steps("cpu", None, **AE_CASES[case]))


def test_dropout_row_shard_draws_the_whole_batch():
    """A block of rows drops what the whole batch drops there."""
    from ae_waveforms_tpu_torch.models.layers import RowShard, dropout

    x = torch.ones(6, 5, 3)
    whole = dropout(x, 0.5, torch.Generator().manual_seed(3), True)
    part = dropout(x[2:5], 0.5, RowShard(torch.Generator().manual_seed(3), 6, slice(2, 5)), True)
    assert torch.equal(part, whole[2:5])
