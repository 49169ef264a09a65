"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test decides inside itself whether a card is present
and skips with a reason when none is.  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.models import conv_ae
from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.ops import _build
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
from ae_waveforms_tpu_torch.classify import gbt
from ae_waveforms_tpu_torch.classify.gbt import GBTEnsemble, _route_leaves
from ae_waveforms_tpu_torch.ops.gbt_route import (
    route_levels, route_levels_reference, route_rows, route_rows_reference, route_spans,
)
from ae_waveforms_tpu_torch.ops.gbt_split import split_level, split_level_reference
from ae_waveforms_tpu_torch.ops.lstm_encoder import encode_fused, encode_fused_reference
from ae_waveforms_tpu_torch.traditional.reconstruction import reconstruct_gaussian_sweep
from ae_waveforms_tpu_torch.train.checkpoint import tree_leaves
from ae_waveforms_tpu_torch.train.loop import batch_loss, train_step
from ae_waveforms_tpu_torch.train.optimizers import make_optimizer
from test_torch_gbt_split import VARIANTS, level_inputs

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("B,T,hidden,latent", [(64, 320, (128, 64), 10), (1, 320, (128, 64), 2),
                                               (5, 40, (16, 8), 20), (256, 320, (128, 64), 10),
                                               (37, 320, (128, 64), 10), (128, 320, (128, 64), 10)])
def test_encoder_kernel_matches_plain(B, T, hidden, latent):
    dev = _card()
    model = LSTMAutoencoder(latent, hidden, generator=torch.Generator().manual_seed(B), device=dev)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, T, 1)).astype(np.float32)).to(dev)
    before = _build.launches["lstm_encoder"]
    with torch.no_grad():
        got = encode_fused(model.jax_tree(), x)
        ref = encode_fused_reference(model.jax_tree(), x)
    torch.cuda.synchronize()
    assert _build.launches["lstm_encoder"] == before + 1
    assert (got - ref).abs().max().item() <= 2e-5


def _beats(B, dev, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((B, 320, 1)).astype(np.float32)).to(dev)


def test_train_step_gives_every_parameter_a_gradient():
    """One training step of the default model on the card, dropout 0.2: the
    encoder runs as cuDNN LSTMs in train mode, so every parameter, the
    encoder's included, gets a finite gradient that is not all zero."""
    dev = _card()
    model = LSTMAutoencoder(device=dev).train()
    optimizer = make_optimizer("adam", model.parameters(), 1e-3)
    x = _beats(16, dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    idx = torch.arange(16, device=dev)
    loss = train_step(model, optimizer, x, idx, torch.ones(16, dtype=torch.bool, device=dev), 1e-3, generator, 0.2,
                      "mse")
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()) and bool((p.grad != 0).any()), name


def _step_gradients(device, x, fp32_backward=True):
    """Each parameter's gradient after one train step of the default model
    from seed 5's init, dropout 0; with ``fp32_backward`` False the same
    loss's backward runs outside ``cudnn_fp32``, under the process's flags."""
    model = LSTMAutoencoder(generator=torch.Generator().manual_seed(5), device=device).train()
    x = x.to(device)
    idx, mask = torch.arange(len(x), device=device), torch.ones(len(x), dtype=torch.bool, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    if fp32_backward:
        train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), x, idx, mask, 0.0, generator, 0.0, "mse")
    else:
        batch_loss(model, x, idx, mask, generator, 0.0, "mse").backward()
    return {name: p.grad.double().cpu() for name, p in model.named_parameters()}


def test_train_step_gradients_keep_full_float32_under_tf32_flags():
    """With both TF32 flags on, one train step's gradients on the card
    agree with the CPU's within 1e-4 of each leaf's largest |g|, and the
    step leaves both flags on: its backward runs in full float32.  The same
    loss with its backward outside ``cudnn_fp32``, so in TF32, must miss
    that tolerance: the check can see the fault it guards against."""
    dev = _card()
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    x = _beats(32, "cpu", seed=32)
    try:
        for f in flags:
            f.allow_tf32 = True
        ref = _step_gradients("cpu", x)
        card, tf32 = (_step_gradients(dev, x, fp32) for fp32 in (True, False))
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    err = {k: float((card[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref}
    tf32_err = max(float((tf32[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref)
    print(f"one step's gradients against the CPU's: the trainer's step {max(err.values()):.3e}, its backward in "
          f"TF32 {tf32_err:.3e} (tolerance 1e-4)")
    assert all(v <= 1e-4 for v in err.values()), err
    assert tf32_err > 1e-4


def _toy_arrays(n_cases=24, per_case=16, seed=0):
    """384 random 320-sample beats of 24 case ids."""
    from ae_waveforms_tpu_torch.core.schema import ArraySet

    n = n_cases * per_case
    info = np.stack([np.repeat(np.arange(n_cases) + 100, per_case), np.arange(n)], 1).astype(np.float64)
    waves = np.random.default_rng(seed).standard_normal((n, 320)).astype(np.float32)
    return ArraySet(waves, np.zeros((n, 35), np.float32), info)


def _recorded_main_train(root, model_class, graphed, max_steps, resume_dir=None):
    """``main_train`` on the card (B = 32, validation every 5 steps, dropout
    0.2, the cosine schedule, so a new learning rate every step), in a data
    and results dir of its own under ``root``; with ``graphed`` False the
    step is kept eager.  Returns the run dir, the counters' moves and, per
    step, the loss and every parameter, first and second moment and step
    count after it."""
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.train import loop

    cfg = TrainConfig(dataset_dir=os.path.join(root, "data"), results_dir=os.path.join(root, "results"), seed=0,
                      model_class=model_class, batch_size=32, validation_interval=5, dropout=0.2,
                      split_size_val=0.2, split_size_test=0.1, lr_scheduler_type="CosineAnnealing", plotting=False)
    records, step, graphable = [], loop.train_step, loop._graphable

    def recorded(model, optimizer, *args):
        loss = step(model, optimizer, *args)
        params = list(model.parameters())
        records.append((loss, [p.detach().clone() for p in params],
                        [optimizer.state[p][k].clone() for p in params for k in ("mu", "nu")],
                        [optimizer.state[p]["step"] for p in params]))
        return loss

    before = (train_step.captures, train_step.replays)
    loop.train_step = recorded
    if not graphed:
        loop._graphable = lambda *a: False
    try:
        run = loop.main_train(cfg, _toy_arrays(), max_steps=max_steps, resume_dir=resume_dir, device=_card())
    finally:
        loop.train_step, loop._graphable = step, graphable
    torch.cuda.synchronize()
    return run, (train_step.captures - before[0], train_step.replays - before[1]), records


def _assert_same_steps(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a[0], b[0]), f"step {k}: loss {float(a[0])} != {float(b[0])}"
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1])), f"step {k}: parameters"
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2])), f"step {k}: moments"
        assert a[3] == b[3], f"step {k}: step counts"


@pytest.mark.parametrize("model_class", ["LSTMAutoencoder", "LeNet5AutoencoderAvgPool"])
def test_train_step_graph_equals_eager_steps(tmp_path, model_class):
    """20 steps or a few more (``max_steps`` ends a chunk) of ``main_train``
    on the card, its step a captured graph replayed from the second call
    on, against the same run with the step kept eager, from the same seed:
    every loss, parameter, moment and step count equal bit for bit, through
    a new learning rate every step, validations and checkpoints between
    replays; and again over 8 steps or more resumed from each run's last
    checkpoint.  The conv autoencoder's backward sums with atomics (cuDNN's,
    and the upsample's index_add), so its two runs are compared under
    ``torch.use_deterministic_algorithms``; the LSTM autoencoder's as the
    trainer runs it."""
    from ae_waveforms_tpu_torch.train import checkpoint as ckpt

    deterministic = model_class != "LSTMAutoencoder"
    torch.use_deterministic_algorithms(deterministic)
    try:
        runs = {graphed: _recorded_main_train(str(tmp_path / f"{graphed}"), model_class, graphed, 20)
                for graphed in (True, False)}
        n = len(runs[True][2])
        assert n >= 20 and runs[True][1] == (1, n - 1) and runs[False][1] == (0, 0)
        _assert_same_steps(runs[True][2], runs[False][2])
        assert len({float(r[0]) for r in runs[True][2]}) == n
        assert len({r[0].data_ptr() for r in runs[True][2]}) == n
        resumed = {}
        for graphed in (True, False):
            at = int(ckpt.load_train_state(ckpt.latest_resumable(runs[graphed][0]))["step"])
            assert at > 1
            resumed[graphed] = _recorded_main_train(str(tmp_path / f"resumed-{graphed}"), model_class, graphed, at + 8,
                                                    resume_dir=runs[graphed][0])
        n = len(resumed[True][2])
        assert n >= 8 and resumed[True][1] == (1, n - 1) and resumed[False][1] == (0, 0)
        _assert_same_steps(resumed[True][2], resumed[False][2])
    finally:
        torch.use_deterministic_algorithms(False)


def test_train_step_graph_captures_again_for_new_shapes_or_data():
    """Three steps at B = 16, three at B = 8, then three on new data: each
    set runs one eager step, captures at the next and replays it; every
    call's loss is a finite tensor of its own."""
    dev = _card()
    model = LSTMAutoencoder(generator=torch.Generator().manual_seed(4), device=dev).train()
    optimizer = make_optimizer("adam", model.parameters(), 1e-3)
    generator = torch.Generator(device=dev).manual_seed(0)
    before = (train_step.captures, train_step.replays)
    losses, moves = [], []
    for B, x in ((16, _beats(64, dev)), (8, None), (8, _beats(64, dev, seed=1))):
        data = x if x is not None else data
        for k in range(3):
            idx = torch.arange(B, device=dev, dtype=torch.int32) + 4 * k
            losses.append(train_step(model, optimizer, data, idx, torch.ones(B, dtype=torch.bool, device=dev), 1e-3,
                                     generator, 0.2, "mse"))
        moves.append((train_step.captures - before[0], train_step.replays - before[1]))
    assert moves == [(1, 2), (2, 4), (3, 6)]
    assert len({loss.data_ptr() for loss in losses}) == len(losses)
    assert all(bool(torch.isfinite(loss)) for loss in losses)


def test_encode_fused_refuses_autograd():
    """The kernel has no backward: under grad it raises on the card rather
    than hand back a latent that gradients cannot reach through."""
    dev = _card()
    model = LSTMAutoencoder(device=dev).eval()
    x = _beats(4, dev)
    before = _build.launches["lstm_encoder"]
    with pytest.raises(RuntimeError, match="no backward"):
        encode_fused(model.jax_tree(), x)
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)
    assert _build.launches["lstm_encoder"] == before
    with torch.no_grad():
        assert model.encode(x).shape == (4, 10)
    assert _build.launches["lstm_encoder"] == before + 1


def test_train_mode_forward_matches_eval_mode():
    """With dropout 0, the train-mode forward (cuDNN encoder) and the
    eval-mode forward (the fused encoder kernel) agree within 1e-4."""
    dev = _card()
    model = LSTMAutoencoder(generator=torch.Generator().manual_seed(3), device=dev)
    x = _beats(64, dev, seed=3)
    with torch.no_grad():
        train_out = model.train()(x)
        train_z = model.encode(x)
        eval_out = model.eval()(x)
        eval_z = model.encode(x)
    assert (train_z - eval_z).abs().max().item() <= 2e-5
    assert (train_out - eval_out).abs().max().item() <= 1e-4


def test_decoder_keeps_full_float32_under_tf32_flags():
    """With both TF32 flags on, the model on the card in eval mode (its
    encoder on the kernel) agrees with the CPU within the reconstruction
    tolerance, and leaves both flags on.  The same decoder run without the
    model's own switch, so in TF32, must miss that tolerance by far on the
    second model (its decoder's weights tripled, as a trained model's
    outgrow their init): the check can see the fault it guards against."""
    dev = _card()
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 320, 1)).astype(np.float32))
    try:
        for f in flags:
            f.allow_tf32 = True
        for scale in (1.0, 3.0):
            gpu_model, cpu_model = LSTMAutoencoder(device=dev).eval(), LSTMAutoencoder(device="cpu").eval()
            with torch.no_grad():
                for model in (gpu_model, cpu_model):
                    for layer in (model.dec1, model.dec2, model.dec3):
                        layer.weight_ih_l0.mul_(scale)
                        layer.weight_hh_l0.mul_(scale)
                gpu = gpu_model(x.to(dev)).cpu()
                cpu = cpu_model(x)
                h = gpu_model.encode(x.to(dev))[:, None, :].expand(-1, x.shape[1], -1).contiguous()
                for layer in (gpu_model.dec1, gpu_model.dec2, gpu_model.dec3):  # cuDNN under the TF32 flags
                    h, _ = layer(h)
                tf32 = (h * gpu_model.out.weight[:, 0] + gpu_model.out.bias).cpu()
            err, tf32_err = (gpu - cpu).abs().max().item(), (tf32 - cpu).abs().max().item()
            print(f"decoder weights x{scale}: the model on the card against the CPU {err:.3e}, "
                  f"its decoder in TF32 {tf32_err:.3e} (tolerance 1e-4)")
            assert [f.allow_tf32 for f in flags] == [True, True]
            assert err <= 1e-4
        assert tf32_err >= 1e-3
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@pytest.fixture
def tf32_flags():
    """Both TF32 flags on inside the test, as they were after it."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    yield flags
    for f, v in zip(flags, saved):
        f.allow_tf32 = v


def _rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def test_conv_ae_forward_keeps_full_float32_under_tf32_flags(tf32_flags, monkeypatch):
    """With both TF32 flags on, the conv autoencoder's eval forward on the
    card (its latent and its reconstruction) agrees with the CPU's within
    1e-4 of each one's largest |value|, and leaves both flags on.  The same
    forward with the model's ``cudnn_fp32`` a no-op, so its convolutions in
    TF32, must miss that: the check can see the fault it guards against
    (the latent shows it; at random weights the reconstruction's error
    stays small beside its bias)."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 1, 320)).astype(np.float32))
    cpu_model, card_model = (LeNet5AutoencoderAvgPool(generator=torch.Generator().manual_seed(7), device=d).eval()
                             for d in ("cpu", dev))

    def outputs(model, x):
        with torch.no_grad():
            return model.encode(x).cpu(), model(x).cpu()

    ref = outputs(cpu_model, x)
    card = outputs(card_model, x.to(dev))
    assert [f.allow_tf32 for f in tf32_flags] == [True, True]
    monkeypatch.setattr(conv_ae, "cudnn_fp32", contextlib.nullcontext)
    tf32 = outputs(card_model, x.to(dev))
    err, tf32_err = ([_rel_err(a, b) for a, b in zip(out, ref)] for out in (card, tf32))
    print(f"conv AE forward against the CPU (max |diff| / max |ref| of the latent, the reconstruction): "
          f"{err[0]:.3e}, {err[1]:.3e}; in TF32 {tf32_err[0]:.3e}, {tf32_err[1]:.3e} (tolerance 1e-4)")
    assert max(err) <= 1e-4
    assert max(tf32_err) > 1e-4


def _conv_step_gradients(device, x):
    """Each parameter's gradient after one train step of the conv
    autoencoder from seed 5's init, dropout 0, at learning rate 0."""
    model = LeNet5AutoencoderAvgPool(generator=torch.Generator().manual_seed(5), device=device).train()
    x = x.to(device)
    idx, mask = torch.arange(len(x), device=device), torch.ones(len(x), dtype=torch.bool, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), x, idx, mask, 0.0, generator, 0.0, "mse")
    return {name: p.grad.double().cpu() for name, p in model.named_parameters()}


def test_conv_ae_train_step_gradients_keep_full_float32_under_tf32_flags(tf32_flags, monkeypatch):
    """With both TF32 flags on, one conv train step's gradients on the card
    agree with the CPU's within 1e-4 of each leaf's largest |g|.  The same
    step with its forward and backward outside ``cudnn_fp32`` (the model's
    a no-op, the trainer's too) must miss that tolerance."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(32).standard_normal((32, 1, 320)).astype(np.float32))
    ref = _conv_step_gradients("cpu", x)
    card = _conv_step_gradients(dev, x)
    assert [f.allow_tf32 for f in tf32_flags] == [True, True]
    monkeypatch.setattr(conv_ae, "cudnn_fp32", contextlib.nullcontext)
    monkeypatch.setattr("ae_waveforms_tpu_torch.train.loop.cudnn_fp32", contextlib.nullcontext)
    tf32 = _conv_step_gradients(dev, x)
    err = {k: _rel_err(card[k], ref[k]) for k in ref}
    tf32_err = max(_rel_err(tf32[k], ref[k]) for k in ref)
    print(f"conv AE step's gradients against the CPU's: {max(err.values()):.3e}, in TF32 {tf32_err:.3e} "
          f"(tolerance 1e-4)")
    assert all(v <= 1e-4 for v in err.values()), err
    assert tf32_err > 1e-4


@pytest.mark.parametrize("matmul,cudnn", [(True, True), (False, False), (True, False)])
def test_conv_ae_leaves_the_tf32_flags(matmul, cudnn):
    """A conv forward and backward on the card leave the process's TF32
    flags as they were."""
    dev = _card()
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f, v in zip(flags, (matmul, cudnn)):
            f.allow_tf32 = v
        model = LeNet5AutoencoderAvgPool(device=dev).train()
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 1, 320)).astype(np.float32)).to(dev)
        idx, mask = torch.arange(8, device=dev), torch.ones(8, dtype=torch.bool, device=dev)
        train_step(model, make_optimizer("adam", model.parameters(), 1e-3), x, idx, mask, 1e-3,
                   torch.Generator(device=dev).manual_seed(0), 0.2, "mse")
        with torch.no_grad():
            model.eval()(x)
        assert [f.allow_tf32 for f in flags] == [matmul, cudnn]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def _fiducials(rng, n):
    """(n, 11) fiducials in ms from R, R at 0 and y -1e-10, 3 NaN x on a
    third of the beats; baselines, a NaN one on a fifth."""
    base_x = np.array([-180.0, -160.0, -140.0, -35.0, -20.0, 0.0, 25.0, 40.0, 120.0, 180.0, 240.0])
    x = base_x + rng.uniform(-6, 6, size=(n, 11))
    y = -1.0 + rng.uniform(-0.2, 0.2, size=(n, 11))
    x[:, 5], y[:, 5] = 0.0, -1e-10
    x[::3, [1, 4, 8]] = np.nan
    b = np.nanmean(y[:, [1, 2, 8, 10]], axis=1)
    b[::5] = np.nan
    return x.astype(np.float32), y.astype(np.float32), b.astype(np.float32)


def test_reconstruct_gaussian_sweep_matches_the_cpu():
    """The reconstruction sweep on the card against the CPU within 5e-5,
    the JAX reconstruction's own tolerance against its oracle."""
    dev = _card()
    rng = np.random.default_rng(9)
    xs, ys, bs = _fiducials(rng, 300)
    x_t = (np.linspace(-106, 213, 320) / 500 * 1000).astype(np.float32)
    maps = rng.integers(1, 6, size=(40, 12)).astype(np.float32)
    card = reconstruct_gaussian_sweep(xs, ys, x_t, bs, maps, device=dev)
    assert card.device.type == "cuda"
    cpu = reconstruct_gaussian_sweep(xs, ys, x_t, bs, maps, device="cpu")
    assert card.shape == cpu.shape == (40, 300, 320)
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=5e-5, equal_nan=True)


# (S, n, n_nodes): the serving head's levels, a wide level, the fit's deepest
# levels (96 fits at 32 nodes, the deep bucket's 24 at 512, the PPV sweep's 25
# at 128), rows not a multiple of the 4-id vector, one fit
@pytest.mark.parametrize("S,n,n_nodes", [(100, 64, 1), (100, 256, 32), (3, 1000, 1024), (96, 12500, 32),
                                         (24, 12000, 512), (25, 12500, 128), (7, 1001, 8), (5, 37, 4),
                                         (1, 12500, 32), (3, 1000, 2**16)])
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


# bins and thresholds anywhere in int32 (past 2^23 and 2^24, the ends):
# staged and in place, one level and a heap
INT32_EDGES = np.array([-2**31, -2**31 + 1, -2**24 - 1, -2**24, -2**23 - 1, -2**23, -1, 0, 1, 2**23 - 1, 2**23,
                        2**24, 2**24 + 1, 2**31 - 2, 2**31 - 1], np.int64)


@pytest.mark.parametrize("S,n,d0,d1", [(96, 12500, 5, 6), (100, 64, 5, 6), (3, 1000, 10, 11), (100, 256, 0, 6),
                                       (9, 1001, 3, 8)])
def test_route_kernel_is_exact_for_any_int32(S, n, d0, d1):
    dev = _card()
    rng = np.random.default_rng(S + d1)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    bins_t = t(rng.choice(INT32_EDGES, size=(n, 10)).astype(np.int32)).T
    node = None if d0 == 0 else t(rng.integers(0, 2**d0, size=(S, n)).astype(np.int32))
    feat = t(rng.integers(0, 10, size=(S, 2**d1)).astype(np.int32))
    thresh = t(rng.choice(INT32_EDGES, size=(S, 2**d1)).astype(np.int32))
    split = t(rng.random((S, 2**d1)) < 0.8)
    before = _build.launches["gbt_route"]
    got = route_levels(bins_t, node, feat, thresh, split, d0, d1)
    assert _build.launches["gbt_route"] == before + 1
    assert torch.equal(got, route_levels_reference(bins_t, node, feat, thresh, split, d0, d1))
    if d1 == d0 + 1:
        c = 2**d0 - 1
        level = (feat[:, c:2 * c + 1], thresh[:, c:2 * c + 1], split[:, c:2 * c + 1])
        assert torch.equal(route_rows(bins_t, node, *level), got)


def _heaps(rng, dev, S, D, F=10):
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(rng.integers(-1, F + 1, size=(S, 2**D)).astype(np.int32)),
            t(rng.integers(0, 64, size=(S, 2**D)).astype(np.int32)), t(rng.random((S, 2**D)) < 0.8))


# (S, n, d0, d1, strided): full heaps from the root at the serving head's
# shapes and the PPV prediction's, mid-heap ranges, bins as a ``bins.T``
# view or contiguous, rows not a multiple of 4, one tree
@pytest.mark.parametrize("S,n,d0,d1,strided", [
    (100, 64, 0, 6, True), (100, 256, 0, 6, True), (12500, 500, 0, 8, True), (100, 256, 2, 6, False),
    (9, 1001, 3, 8, True), (1, 37, 0, 4, False), (50, 300, 5, 6, True),
])
def test_route_levels_kernel_matches_plain_exactly(S, n, d0, d1, strided):
    dev = _card()
    rng = np.random.default_rng(S + n + d0)
    bins = torch.from_numpy(rng.integers(0, 64, size=(n, 10)).astype(np.int32)).to(dev)
    bins_t = bins.T if strided else bins.T.contiguous()
    # level d0's ids, a tenth of them outside the level (negative or too large)
    node = None if d0 == 0 else torch.from_numpy(
        rng.integers(-(2**d0) // 10 - 1, 2**d0 + 2**d0 // 10 + 1, size=(S, n)).astype(np.int32)).to(dev)
    heaps = _heaps(rng, dev, S, d1)
    before = _build.launches["gbt_route"]
    got = route_levels(bins_t, node, *heaps, d0, d1)
    assert _build.launches["gbt_route"] == before + 1
    assert torch.equal(got, route_levels_reference(bins_t, node, *heaps, d0, d1))


def test_route_leaves_is_one_launch():
    dev = _card()
    rng = np.random.default_rng(3)
    feat, thresh, split = _heaps(rng, dev, 100, 6)
    ens = GBTEnsemble(feat, thresh, split, torch.from_numpy(rng.standard_normal((100, 64)).astype(np.float32)).to(dev),
                      torch.tensor(0.3, device=dev))
    bins = torch.from_numpy(rng.integers(0, 64, size=(64, 10)).astype(np.int32)).to(dev)
    before = _build.launches["gbt_route"]
    leaf = _route_leaves(ens, bins, 6)
    assert _build.launches["gbt_route"] == before + 1
    cpu = GBTEnsemble(*(x.cpu() for x in ens))
    assert torch.equal(leaf.cpu(), _route_leaves(cpu, bins.cpu(), 6))


def test_route_leaves_at_depth_16():
    """Trees deeper than one launch's shared memory holds route in the
    launches of ``route_spans``: levels [0, 14) staged, then one each."""
    dev = _card()
    rng = np.random.default_rng(16)
    feat, thresh, split = _heaps(rng, dev, 3, 16)
    ens = GBTEnsemble(feat, thresh, split, torch.from_numpy(rng.standard_normal((3, 2**16)).astype(np.float32)).to(dev),
                      torch.tensor(0.3, device=dev))
    bins = torch.from_numpy(rng.integers(0, 64, size=(3000, 10)).astype(np.int32)).to(dev)
    before = _build.launches["gbt_route"]
    leaf = _route_leaves(ens, bins, 16)
    assert _build.launches["gbt_route"] == before + len(route_spans(10, 0, 16)) == before + 3
    cpu = GBTEnsemble(*(x.cpu() for x in ens))
    assert torch.equal(leaf.cpu(), _route_leaves(cpu, bins.cpu(), 16))


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
    before = _build.launches["gbt_hist"]
    q1 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=n_bins, packed=packed)
    q2 = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=n_bins)
    assert _build.launches["gbt_hist"] == before + 2
    assert torch.equal(q1, q2)  # bit-identical across calls, packed once or per call
    assert torch.equal(q1, left_histograms_fixed_reference(binsT, g, h, node, shift, half=half, n_bins=n_bins))
    got = left_histograms(binsT, g, h, node, half=half, n_bins=n_bins)
    torch.testing.assert_close(got, left_histograms_reference(binsT, g, h, node, half=half, n_bins=n_bins),
                               atol=1e-4, rtol=1e-5)


# (S, n, F, n_bins, depth, case): the grid search's chunks (27 fits to
# depth 6, 21 to depth 10, the widest level of each), the study's 96 fits,
# one fit on 20 and on 149 rows at a level of 256 nodes, the PPV sweep's 25
# seeds on 35 features, two-byte bins, and the edge cases: nothing
# feasible, exact ties, gamma pruning, depth limits below the level
SPLIT_CASES = [
    (27, 12000, 10, 64, 0, "plain"), (27, 12000, 10, 64, 5, "plain"), (21, 12000, 10, 64, 9, "plain"),
    (96, 12000, 10, 64, 4, "plain"), (1, 20, 10, 64, 8, "plain"), (1, 149, 10, 64, 8, "plain"),
    (25, 6000, 35, 64, 3, "plain"), (5, 3000, 10, 300, 3, "plain"), (21, 12000, 10, 64, 6, "infeasible"),
    (27, 12000, 10, 64, 5, "ties"), (27, 12000, 10, 64, 5, "gamma"), (21, 12000, 10, 64, 7, "limits"),
]


@pytest.mark.parametrize("last", [False, True], ids=["inner", "last"])
@pytest.mark.parametrize("S,n,F,n_bins,depth,case", SPLIT_CASES)
def test_split_kernel_matches_plain_bit_for_bit(S, n, F, n_bins, depth, case, last):
    dev = _card()
    a = level_inputs(S, n, F, n_bins, depth, seed=depth * 7 + F, dev=dev, **VARIANTS[case])
    # the kernel writes row views of ensemble heaps, as the fit hands them
    ens = [tuple(torch.zeros((S, 3, 2**(depth + 1)), dtype=x.dtype, device=dev) for x in a["heap"]) for _ in range(2)]
    kw = dict(depth=depth, n_bins=n_bins, last=last)
    before = _build.launches["gbt_split"]
    got = split_level(**{**a, "heap": tuple(x[:, 1] for x in ens[0])}, **kw)
    assert _build.launches["gbt_split"] == before + 1
    want = split_level_reference(**{**a, "heap": tuple(x[:, 1] for x in ens[1])}, **kw)
    torch.cuda.synchronize()
    for key in ("hist", "leaf_sums"):
        x, y = getattr(got, key), getattr(want, key)
        assert (x is None) == (y is None) and (x is None or (x.dtype == y.dtype and torch.equal(x, y))), key
    for x, y in zip(*ens):
        assert torch.equal(x, y)
    _, bb, split = (x[:, 1, 2**depth - 1:2**(depth + 1) - 1] for x in ens[1])
    if case == "infeasible":
        assert not split.any()
    elif case == "ties":  # the even bin before each empty odd one wins
        assert split.any() and (bb[split] % 2 == 0).all()
    elif case in ("gamma", "limits"):
        assert split.any() and not split.all()


def test_fit_on_the_card_equals_the_fit_on_the_cpu():
    dev = _card()
    rng = np.random.default_rng(18)
    S, n, F, depth, trees = 6, 3000, 10, 6, 12
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 3] + rng.standard_normal(n) > 0).astype(np.float32)
    bins = gbt.bin_data(torch.from_numpy(X), torch.from_numpy(gbt.compute_bin_edges(X)))
    w = (rng.random((S, n)) < 0.7).astype(np.float32)
    hp = (rng.uniform(0.05, 0.3, S), rng.uniform(0, 2, S), rng.integers(1, 8, S).astype(np.float64),
          rng.uniform(0.5, 1, S), rng.uniform(0.5, 1, S), rng.integers(trees // 2, trees + 1, S))
    kw = dict(max_depth=depth, n_estimators=trees, depth_limits=rng.integers(2, depth + 1, S))
    before = _build.launches["gbt_split"]
    card = gbt.fit_gbt_sweep_margins(bins.to(dev), y, w, np.arange(S), *hp, **kw)
    assert _build.launches["gbt_split"] == before + trees * depth
    cpu = gbt.fit_gbt_sweep_margins(bins, y, w, np.arange(S), *hp, **kw)
    (ens_card, margin_card), (ens_cpu, margin_cpu) = card, cpu
    for name in ("feat", "thresh", "is_split"):
        assert torch.equal(getattr(ens_card, name).cpu(), getattr(ens_cpu, name)), name
    assert ens_cpu.is_split.any()
    assert torch.equal(margin_card.cpu(), margin_cpu)


def test_split_level_raises_on_mixed_devices():
    dev = _card()
    a = level_inputs(2, 100, 3, 16, 1, seed=1, dev=dev)
    kw = dict(depth=1, n_bins=16, last=False)
    for change in (dict(shift=a["shift"].cpu()), dict(parent=a["parent"].cpu()),
                   dict(heap=(a["heap"][0].cpu(), *a["heap"][1:]))):
        with pytest.raises(ValueError):
            split_level(**{**a, **change}, **kw)


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
    heap = torch.zeros((2, 2**6), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a heap of 6 levels holds no level 6
        route_levels(z, None, heap, heap, heap.bool(), 0, 7)
    g = torch.zeros((2, 4), device=dev)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g.double(), g, z, z[:, 0], half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms_fixed(z, g, g, z, z[:, 0].cpu(), half=1, n_bins=64)
    with pytest.raises(ValueError):  # more bins than a block's shared memory holds
        left_histograms_fixed(z, g, g, z, z[:, 0].contiguous(), half=1, n_bins=16384)
    with pytest.raises(ValueError):  # packed bins of another pool
        left_histograms_fixed(z, g, g, z, z[:, 0].contiguous(), half=1, n_bins=64, packed=pack_bins(z[:, :2], 64))


# extraction: every device stage on the card against the port's CPU, with
# chip_smoke.py phase 10's tolerances (R peaks, peak counts, the QC mask and
# the fiducials exact; median beats 1e-6; feature rows 1e-5; the device
# filtfilt 1e-6), and the float64 host engine on the card against the goldens

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "extraction_golden.npz")


def _extraction_windows():
    """The golden windows and those of a normal and a 150-bpm record, float32."""
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data.extract import _windows, preprocess_record
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    z = np.load(GOLDEN)
    wins = [z["window"]] + [z[f"patho_{m}_window"] for m in ("absent_p", "biphasic_t", "fused_qrs", "tall_t")]
    cfg = ExtractionConfig(precision="float64")
    for kw in (dict(seed=21), dict(seed=22, hr_bpm=150.0)):
        wins += list(_windows(preprocess_record(synthetic_ecg_record(duration_s=125.0, **kw), cfg), cfg)[0])
    return np.stack(wins).astype(np.float32)


def _stages(x):
    from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch
    from ae_waveforms_tpu_torch.signals.features_device import feature_rows_batch
    from ae_waveforms_tpu_torch.signals.median_beat import median_beat_batch
    from ae_waveforms_tpu_torch.signals.qc import qc_mask
    from ae_waveforms_tpu_torch.signals.rpeaks import find_rpeaks_batch

    peaks, n = find_rpeaks_batch(x, 500)
    fid = delineate_batch(x, peaks, n)
    out = dict(peaks=peaks, n=n, keep=qc_mask(x, peaks, n), median=median_beat_batch(x, peaks, n),
               fid=torch.stack(list(fid.values())), rows=feature_rows_batch(x, peaks, n, fid))
    return {k: v.cpu() for k, v in out.items()}


def test_extraction_stages_match_the_cpu():
    dev = _card()
    x = _extraction_windows()
    card, cpu = _stages(torch.from_numpy(x).to(dev)), _stages(torch.from_numpy(x))
    for k in ("peaks", "n", "keep"):
        assert torch.equal(card[k], cpu[k]), k
    torch.testing.assert_close(card["fid"], cpu["fid"], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(card["median"], cpu["median"], rtol=0, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(card["rows"], cpu["rows"], rtol=0, atol=1e-5, equal_nan=True)
    assert card["keep"].any() and (card["n"] > 48).any()


def test_device_filtfilt_matches_the_cpu():
    from ae_waveforms_tpu_torch.signals.filters import butterworth, butterworth_batched

    dev = _card()
    rng = np.random.default_rng(4)
    t = np.arange(60000) / 500.0
    x = np.sin(2 * np.pi * 1.3 * t) + 0.4 * np.sin(2 * np.pi * 0.2 * t) + 0.3 * rng.standard_normal(len(t))
    x[20000:20100] = np.nan
    x[40000:40005] = np.nan
    x[40010:40500] = np.nan  # a 5-sample segment passes through
    for btype, cut in (("high", 1.0), ("low", 30.0)):
        card = butterworth(x, btype, cut, 500, 4, precision="float32", device=dev)
        cpu = butterworth(x, btype, cut, 500, 4, precision="float32", device="cpu")
        np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-6, equal_nan=True)
    card = butterworth_batched([x, x[:7000]], 1.0, 30.0, 500, 4, device=dev)
    cpu = butterworth_batched([x, x[:7000]], 1.0, 30.0, 500, 4, device="cpu")
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, equal_nan=True)


def test_host_engine_on_the_card_matches_goldens():
    """Features within 1e-7, not the CPU tests' 1e-9: the reference's
    float64 ba-form filtfilt is ill-conditioned enough (the 1 Hz high-pass)
    that another scipy build parts from the one the goldens were frozen with
    by ~1e-8 on this record (chip_smoke.py's ``filter_conditioning``)."""
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data.extract import extract_case
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    dev = _card()
    z = np.load(GOLDEN)
    cfg = ExtractionConfig(precision="float64", delineation_engine="host")
    for prefix, cid, kw in (("", 1, dict(seed=1234)), ("gap_", 2, dict(seed=4321, nan_gaps=2))):
        got = extract_case(cid, synthetic_ecg_record(duration_s=85.0, **kw), cfg, device=dev)
        np.testing.assert_allclose(got.waves, z[prefix + "waves"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.features, z[prefix + "features"], rtol=0, atol=1e-7, equal_nan=True)
        np.testing.assert_array_equal(got.indices, z[prefix + "indices"])


def test_device_engine_streams_with_the_full_width_rerun_on_the_card():
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data.extract import ExtractionStats, extract_cases
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    dev = _card()
    cfg = ExtractionConfig(precision="float32", delineation_engine="device", filter_backend="device")

    def loader(cid):
        return synthetic_ecg_record(duration_s=65.0, seed=cid, hr_bpm=160.0 if cid == 2 else 72.0)

    per_case = extract_cases([1, 2, 3], loader, cfg, device=dev)
    stats = ExtractionStats()
    streamed = extract_cases([1, 2, 3], loader, cfg, batched=True, windows_per_batch=4, device=dev, stats=stats)
    assert stats.reruns >= 1
    for a, b in zip(per_case, streamed):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.waves, b.waves)
        np.testing.assert_array_equal(a.features, b.features)


# -- stacked multi-config training (train/stacked.py) ----------------------------------------------------------------


def _stacked(kind: str, device, dtype=torch.float32, seeds=(5, 6)):
    """Two configs of the LSTM autoencoder or the LSTM classifier stacked on
    ``device`` in ``dtype``, from the seeds' inits."""
    from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
    from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

    cls = LSTMAutoencoder if kind == "ae" else LSTMClassifier
    models = [cls(generator=torch.Generator().manual_seed(s), device="cpu").to(dtype) for s in seeds]
    return StackedConfigs(cls(device=device).to(dtype).train(), models, device)


def _stacked_step_grads(kind: str, device, fp32_backward: bool = True, dtype=torch.float32):
    """Every config's gradients (float64, on the CPU) after one stacked step
    at B=32, T=320, dropout 0, at learning rate 0, in ``dtype``; with
    ``fp32_backward`` False each loss's backward runs outside
    ``cudnn_fp32``."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.train.multi import multi_step

    stacked = _stacked(kind, device, dtype)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 32, 320, 1)).astype(np.float32)).to(device, dtype)
    y = torch.from_numpy((rng.random((2, 32)) > 0.5).astype(np.float32)).to(device, dtype)
    idx = torch.arange(32, device=device).expand(2, 32)
    mask = torch.ones((2, 32), dtype=torch.bool, device=device)
    generators = [torch.Generator(device=device).manual_seed(s) for s in (0, 1)]
    optimizer = torch.optim.SGD(stacked.param_groups(), lr=0.0)
    if fp32_backward and kind == "ae":
        multi_step(stacked, optimizer, [0, 1], x[0], idx, mask, [0.0, 0.0], generators, 0.0, "mse")
    elif fp32_backward:
        dl.stacked_step(stacked, optimizer, [0, 1], x, y, idx, mask, generators, 0.0, None)
    else:
        for s in (0, 1):
            if kind == "ae":
                loss = batch_loss(stacked.bound(s), x[0], idx[s], mask[s], generators[s], 0.0, "mse")
            else:
                loss = dl.batch_bce(stacked.bound(s), x[s], y[s], idx[s], mask[s], generators[s], 0.0, None)
            loss.backward()
    return {f"{s}.{k}": p.grad.double().cpu() for s, leaves in enumerate(stacked.leaves) for k, p in leaves.items()}


@pytest.mark.parametrize("kind", ["ae", "classifier"])
def test_stacked_step_gradients_keep_full_float32_under_tf32_flags(tf32_flags, kind):
    """With both TF32 flags on, a stacked step's gradients on the card,
    held to the same step in float64 on the CPU by the LSTM leaves'
    gradients together (relative, Frobenius): within 1e-3 and within a
    tenth of the same losses' error with their backward outside
    ``cudnn_fp32``.  At init the classifier's gradients are ill-conditioned
    (BatchNorm over 32 pooled rows, cancelling attention sums): float32
    alone, on the CPU, is 5.8e-5 from float64 over its LSTM leaves."""
    dev = _card()

    def err(got, ref):
        keys = [k for k in ref if "lstm" in k or ".enc" in k or ".dec" in k]
        diff = sum(float((got[k] - ref[k]).square().sum()) for k in keys)
        return (diff / sum(float(ref[k].square().sum()) for k in keys)) ** 0.5

    ref = _stacked_step_grads(kind, "cpu", dtype=torch.float64)
    card = err(_stacked_step_grads(kind, dev), ref)
    tf32 = err(_stacked_step_grads(kind, dev, fp32_backward=False), ref)
    print(f"{kind}: the LSTM leaves' gradients against float64 on the CPU: the card {card:.3e}, in TF32 {tf32:.3e}")
    assert card <= min(1e-3, tf32 / 10)


def test_stacked_step_hands_cudnn_its_weights_in_place():
    """cuDNN warns where an LSTM's weights are not one flat buffer in its
    order (and copies them); the stacked step's flat copies are."""
    import warnings

    dev = _card()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for kind in ("ae", "classifier"):
            _stacked_step_grads(kind, dev)
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]


@pytest.mark.parametrize("kind", ["ae", "classifier"])
def test_stacked_runs_equal_single_runs_on_the_card(kind):
    """Two configs trained together on the card, dropout on, and each
    alone: equal bit for bit (each config runs its own cuDNN calls)."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.train.multi import train_ae_multi

    dev = _card()
    rng = np.random.default_rng(3)
    if kind == "ae":
        import types

        n = 256
        info = np.stack([np.repeat(np.arange(32), 8), np.arange(n)], 1).astype(np.float64)
        arrays = types.SimpleNamespace(waves=rng.standard_normal((n, 320)).astype(np.float32), info=info,
                                       features=np.zeros((n, 35), np.float32))
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            cfg = TrainConfig(dataset_dir=os.path.join(tmp, "d"), results_dir=os.path.join(tmp, "r"), batch_size=32,
                              validation_interval=3, split_size_val=0.2, split_size_test=0.1, plotting=False)
            both = train_ae_multi(cfg, [3, 4], arrays=arrays, max_steps=8, device=dev)
            ones = [train_ae_multi(cfg, [s], arrays=arrays, max_steps=8, device=dev) for s in (3, 4)]
        for i, one in enumerate(ones):
            np.testing.assert_array_equal(both.train_losses[:, i], one.train_losses[:, 0])
            np.testing.assert_array_equal(both.val_losses[:, i], one.val_losses[:, 0])
    else:
        Xs = rng.standard_normal((2, 96, 320, 1)).astype(np.float32)
        ys = (rng.random((2, 96)) > 0.5).astype(np.float32)
        Xvs = rng.standard_normal((2, 32, 320, 1)).astype(np.float32)
        yvs = np.tile(np.r_[np.zeros(16), np.ones(16)], (2, 1))
        kw = dict(num_epochs=2, batch_size=32, device=dev, min_delta=-1.0)
        both = dl.train_classifier_multi(Xs, ys, Xvs, yvs, [0, 1], **kw)
        for i in range(2):
            one = dl.train_classifier(Xs[i], ys[i], Xvs[i], yvs[i], i, **kw)
            for a, b in zip(tree_leaves(both[i]), tree_leaves(one)):
                np.testing.assert_array_equal(a, b)



def test_sharded_ae_step_at_world_1_over_nccl_matches_one_device():
    """One NCCL rank on the card (``parallel.launch``) against the same
    steps in this process: the all-reduce of one rank changes nothing."""
    _card()
    from ae_waveforms_tpu_torch.parallel import dryrun

    kw = dict(latent=10, n_rows=96, batch=32, seq_len=320, optimizer="adam", steps=3)
    got = dryrun.run_sharded([("ae", 1, kw)], ["cuda:0"], "nccl", timeout_s=300)["results"][0]
    want = dryrun.ae_steps(torch.device("cuda:0"), None, **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for layer in want["params"]:
        for k in want["params"][layer]:
            np.testing.assert_allclose(got["params"][layer][k], want["params"][layer][k], rtol=2e-4, atol=2e-5)
