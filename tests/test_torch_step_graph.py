"""The training step's captured-graph path, on the CPU: where it must stay
eager, and Adam's two halves (``load_step``, ``apply_loaded``), which a
captured step replays, against its one-call ``step`` and against the
one-call step as it stood before the split.

Tolerances: none; the device-scalar form and the split step must equal
the host-scalar step bit for bit (the same float32 operations in the same
order).  The graph itself runs only on a card: its bit-for-bit tests
against eager runs are in ``test_torch_kernels_cuda.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.parallel.mesh import Grid
from ae_waveforms_tpu_torch.train import loop
from ae_waveforms_tpu_torch.train.loop import sharded_train_step, train_step
from ae_waveforms_tpu_torch.train.optimizers import Adam, make_optimizer
from ae_waveforms_tpu_torch.train.schedules import cosine_annealing_warm_restarts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group, and its (1, 1) grid."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        yield Grid(1, 1, 0, group, group)
    finally:
        dist.destroy_process_group()


def _lstm(seed=0):
    return LSTMAutoencoder(4, (8, 6), generator=torch.Generator().manual_seed(seed), device="cpu").train()


def _batch(B=8, T=32, n=40, seed=1):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, T, 1)).astype(np.float32))
    return x, torch.arange(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool)


@pytest.mark.parametrize("case", ["cpu", "conv", "grid", "sgd", "ranger", "eval"])
def test_step_stays_eager_off_its_path(case, request):
    """On CPU tensors (the LSTM and the conv autoencoder), under a grid
    (``sharded_train_step``), with an optimizer other than the port's Adam,
    or with the model in eval mode, three steps run eagerly: no capture, no
    replay, finite losses."""
    model, (x, idx, mask) = _lstm(), _batch()
    if case == "conv":
        model = LeNet5AutoencoderAvgPool(4, generator=torch.Generator().manual_seed(0), device="cpu").train()
        x = _batch(T=320)[0].transpose(1, 2).contiguous()
    if case == "eval":
        model.eval()
    opt = make_optimizer({"sgd": "sgd", "ranger": "ranger"}.get(case, "adam"), model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(2)
    step = train_step
    if case == "grid":
        grid = request.getfixturevalue("world_of_one")
        step = lambda *a: sharded_train_step(*a, grid=grid)  # noqa: E731
    before = (train_step.captures, train_step.replays)
    losses = [step(model, opt, x, idx + k, mask, 1e-3, gen, 0.2, "mse") for k in range(3)]
    assert (train_step.captures, train_step.replays) == before
    assert all(bool(torch.isfinite(loss)) for loss in losses)


def test_graph_engages_only_for_adam_in_train_mode():
    """The decision reads the optimizer, the model's mode and the
    generator's device before the data's: with data on the card, SGD, eval
    mode or a CPU generator keep the step eager."""
    card = SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0))
    model = _lstm()
    adam, sgd = make_optimizer("adam", model.parameters(), 1e-3), make_optimizer("sgd", model.parameters(), 1e-3)
    assert not loop._graphable(model, sgd, card, None)
    assert not loop._graphable(model, adam, card, torch.Generator())
    assert not loop._graphable(model.eval(), adam, card, None)
    assert not loop._graphable(model.train(), adam, _batch()[0], torch.Generator())


def test_train_step_returns_a_tensor_of_its_own():
    """Every call's loss is a tensor of its own, which later steps leave as
    it was."""
    model, (x, idx, mask) = _lstm(), _batch()
    opt = make_optimizer("adam", model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(3)
    losses, kept = [], []
    for k in range(4):
        losses.append(train_step(model, opt, x, idx + k, mask, 1e-3, gen, 0.2, "mse"))
        kept.append(losses[-1].clone())
    assert len({loss.data_ptr() for loss in losses}) == 4
    assert all(torch.equal(a, b) for a, b in zip(losses, kept))
    assert len({float(loss) for loss in losses}) == 4


def _seed_adam_step(opt: Adam) -> None:
    """``Adam.step`` as it stood before its split into host and device
    halves: one foreach chain over every group, each scalar a per-tensor
    host number."""
    ps, gs, sc = [], [], {k: [] for k in ("c1", "b1", "c2", "b2", "bias1", "bias2", "eps", "neg_lr")}
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        gps = [p for p in group["params"] if p.grad is not None]
        ggs = [p.grad for p in gps]
        if group["weight_decay"]:
            ggs = torch._foreach_add(ggs, torch._foreach_mul(gps, group["weight_decay"]))
        for p in gps:
            state = opt.state[p]
            if not state:
                state["step"] = 0
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
            state["step"] += 1
        t = np.float32(opt.state[gps[0]]["step"])
        values = dict(c1=1 - b1, b1=b1, c2=1 - b2, b2=b2, bias1=float(np.float32(1) - np.float32(b1) ** t),
                      bias2=float(np.float32(1) - np.float32(b2) ** t), eps=group["eps"],
                      neg_lr=-float(np.float32(group["lr"])))
        for k, v in values.items():
            sc[k] += [v] * len(gps)
        ps += gps
        gs += ggs
    mu = [opt.state[p]["mu"] for p in ps]
    nu = [opt.state[p]["nu"] for p in ps]
    with torch.no_grad():
        torch._foreach_copy_(mu, torch._foreach_add(torch._foreach_mul(gs, sc["c1"]), torch._foreach_mul(mu, sc["b1"])))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_copy_(nu, torch._foreach_add(torch._foreach_mul(g2, sc["c2"]), torch._foreach_mul(nu, sc["b2"])))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, sc["bias2"])), sc["eps"])
        updates = torch._foreach_div(torch._foreach_div(mu, sc["bias1"]), denom)
        torch._foreach_add_(ps, torch._foreach_mul(updates, sc["neg_lr"]))


LRS = ([1e-2] * 4 + [5e-3] * 2  # StepLR, halved by a plateau event after step 3
       + [float(cosine_annealing_warm_restarts(1e-2, 4, eta_min=1e-4)(s)) for s in range(6)])  # a cosine schedule


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_halves_equal_the_one_call_step(weight_decay):
    """12 steps of two param groups (the second with weight decay 0.02)
    through the learning rates of a StepLR halving and a cosine schedule:
    ``load_step`` + ``apply_loaded`` (the per-step scalars read from
    tensors), ``step`` and the step as it stood before the split leave
    equal parameters, moments and step counts after every step."""
    rng = np.random.default_rng(4)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    w0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in LRS]
    runs = []
    for _ in range(3):
        params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
        opt = Adam([{"params": params[:2]}, {"params": params[2:], "weight_decay": 0.02}], lr=LRS[0],
                   weight_decay=weight_decay)
        runs.append((params, opt))
    for lr, g in zip(LRS, grads):
        for (params, opt), apply in zip(runs, ("halves", "step", "seed")):
            for group in opt.param_groups:
                group["lr"] = lr
            for p, gk in zip(params, g):
                p.grad = torch.from_numpy(gk.copy())
            if apply == "halves":
                opt.load_step()
                opt.apply_loaded()
            elif apply == "step":
                opt.step()
            else:
                _seed_adam_step(opt)
        (pa, oa), *others = runs
        for pb, ob in others:
            for a, b in zip(pa, pb):
                assert torch.equal(a, b)
                for k in ("mu", "nu"):
                    assert torch.equal(oa.state[a][k], ob.state[b][k])
                assert oa.state[a]["step"] == ob.state[b]["step"]
    assert runs[0][1].state[runs[0][0][0]]["step"] == len(LRS)


def test_adam_loaded_scalars_are_the_step_scalars():
    """The tensors ``load_step`` writes hold the float32 bias corrections of
    the step count and -lr, in the parameters' dtype and on their device."""
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    opt = Adam([p], lr=3e-3)
    for t in (1, 2):
        p.grad = torch.ones_like(p)
        opt.load_step()
        loaded = opt._loaded[0]
        assert {k: v.dtype for k, v in loaded.items()} == dict.fromkeys(("bias1", "bias2", "neg_lr"), torch.float64)
        assert float(loaded["bias1"]) == float(np.float32(1) - np.float32(0.9) ** np.float32(t))
        assert float(loaded["bias2"]) == float(np.float32(1) - np.float32(0.999) ** np.float32(t))
        assert float(loaded["neg_lr"]) == -float(np.float32(3e-3))
    assert opt.state[p]["step"] == 2
