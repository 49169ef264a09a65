"""AE training loop (the port of the JAX package's ``train/loop.py``;
capability twin of functions_ae/run_train.py).

The training and validation arrays live on the device.  An epoch is a
host-side sequence of chunks of steps (``validation_interval`` steps, the
first chunk one step), each step a batch gather on the device, the forward
and backward pass and the optimizer update (``train_step``; on the card,
with the port's Adam, one captured CUDA graph replayed from a call's second
step on).  The steps' losses stay on the device and come to the host once
per chunk, as the JAX package's scanned chunk returns them; learning rates
are computed on the host from the step count.  Validation runs between
chunks, exactly at the reference's cadence (after local steps 0, V, 2V,
... of each epoch, run_train.py:317-319), with the model in eval mode: the
encoder then runs through the fused encoder kernel, one launch per
validation batch.

Replicated behaviours: loss/optimizer/scheduler selection
(run_train.py:205-248), every-10-steps CSV logging (:305-309), validation
CSV (:327-333), StepLR stepping only on validation-plateau events
(:343-348), early stopping with best-checkpoint retention (:30-103), epoch
rescale for ``nr_train_ids`` runs via the 228,543-sample target (:472), and
final model save (:537-538).  The split and the batch order come from the
global ``np.random`` stream seeded with ``cfg.seed``, as in the JAX package,
so they are equal there and here; init and dropout draw from
``torch.Generator``s seeded with ``cfg.seed``, which cannot give
``jax.random``'s numbers.

Over several devices (``mesh``, a ``parallel.mesh.Grid`` of the ranks that
``parallel.launch.run`` started, one a device) each step splits its batch
over the grid's data axis, as the JAX package shards it over 'data', and
sharding changes no result beyond the order of sums: every rank draws the
same batch order and the same initial weights, and draws each dropout mask
for the whole batch from the one generator before it keeps its own rows
(``layers.RowShard``).  A rank's loss is its rows' share of the batch mean,
Σ_rows(per·w) / Σ_batch(w); its gradients and that share go through one
all-reduce SUM of a flat buffer over the data group, after which the
optimizer runs identically on every rank.  Validation sums its totals and
counts the same way.  The model is replicated over the model axis, whose
ranks compute the same rows.  Rank 0 alone writes files (the run dir, the
logs, the checkpoints and the split masks, which it draws and hands to
the other ranks with the global ``np.random`` state).
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, load_arrays
from ae_waveforms_tpu_torch.models.layers import RowShard
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.parallel.mesh import Grid, all_reduce_sum_, broadcast_object
from ae_waveforms_tpu_torch.train import checkpoint as ckpt
from ae_waveforms_tpu_torch.train.data import layout_waves, split_datasets
from ae_waveforms_tpu_torch.train.logs import CsvLogs, make_tracker, setup_logging
from ae_waveforms_tpu_torch.train.optimizers import Adam, make_optimizer
from ae_waveforms_tpu_torch.train.profiling import span
from ae_waveforms_tpu_torch.train.schedules import (
    cosine_annealing_warm_restarts,
    cosine_annealing_warmup_hard_restarts,
)

__all__ = ["main_train", "batch_loss", "train_step", "sharded_train_step", "validate", "effective_epochs",
           "require_float32"]


def require_float32(cfg: TrainConfig) -> None:
    """The port trains in full float32 (cuDNN inside ``cudnn_fp32``), the
    JAX package's "float32" (its parity mode) and, on the card, its
    "default"; a lower precision raises."""
    if cfg.compute_dtype not in ("default", None, "float32"):
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}: the port trains in float32 only")


def _elementwise_loss(kind: str, pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    if kind == "mse" or kind == "rmse":
        return (pred - true) ** 2
    if kind == "mae":  # SmoothL1
        d = torch.abs(pred - true)
        return torch.where(d < 1.0, 0.5 * d**2, d - 0.5)
    raise ValueError(f"unsupported loss {kind!r}")


def _finalize_loss(kind: str, total, count):
    mean = total / count
    return torch.sqrt(mean) if kind == "rmse" else mean


def _lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Tuple[Callable, bool]:
    if cfg.lr_scheduler_type == "CosineAnnealing":
        t0 = int(steps_per_epoch / cfg.lr_scheduler_caw_settings[0])
        return cosine_annealing_warm_restarts(cfg.lr, t0, eta_min=1e-4), False
    if cfg.lr_scheduler_type == "CosineAnnealingWarmup":
        resets, warm_val, eta_min = cfg.lr_scheduler_caw_settings
        t0 = int(steps_per_epoch / resets)
        warmup = int(warm_val * cfg.validation_interval)
        return cosine_annealing_warmup_hard_restarts(cfg.lr, t0, warmup, eta_min), False
    # StepLR: constant within the schedule; the plateau event scale multiplies it
    return (lambda step: torch.tensor(cfg.lr, dtype=torch.float32)), True


def effective_epochs(cfg: TrainConfig, n_train: int) -> int:
    """Epoch count, rescaled when training on a case-id subsample so the
    total step budget targets ~228,543 samples (run_train.py:472 quirk —
    the upstream formula divides the target by steps-per-epoch, i.e. the
    units are 'samples over batches', preserved as-is)."""
    if cfg.nr_train_ids > 0:
        return int(np.ceil(cfg.target_train_samples / (n_train / cfg.batch_size)))
    return cfg.epochs


def _batched_indices(n: int, batch: int, perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a permutation to full batches; returns (steps, B) indices + mask."""
    steps = math.ceil(n / batch)
    padded = np.zeros(steps * batch, np.int32)
    padded[:n] = perm
    mask = np.zeros(steps * batch, bool)
    mask[:n] = True
    return padded.reshape(steps, batch), mask.reshape(steps, batch)


def _weighted_total(model: nn.Module, data_x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, generator,
                    rate: float, loss_kind: str) -> torch.Tensor:
    """Σ over the rows ``data_x[idx]`` of each row's mean elementwise loss
    through ``model`` times its mask (padding rows, mask False, weigh
    nothing), with its autograd graph.  The gather and the loss are marked
    "gather and loss" for ``torch.profiler``."""
    with span("gather and loss"):
        x = data_x.index_select(0, idx)
        w = mask.to(x.dtype)
    pred = model(x, rate, generator)
    with span("gather and loss"):
        elem = _elementwise_loss(loss_kind, pred, x)
        return (elem.reshape(elem.shape[0], -1).mean(dim=1) * w).sum()


def batch_loss(model: nn.Module, data_x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator, rate: float, loss_kind: str) -> torch.Tensor:
    """The loss of the batch ``data_x[idx]`` through ``model`` in its
    current mode, with its autograd graph."""
    total = _weighted_total(model, data_x, idx, mask, generator, rate, loss_kind)
    with span("gather and loss"):
        return _finalize_loss(loss_kind, total / mask.to(total.dtype).sum().clamp_min(1.0), 1.0)


def _step_body(model: nn.Module, optimizer: torch.optim.Optimizer, data_x: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor, generator, rate: float, loss_kind: str, update: Callable[[], None]) -> torch.Tensor:
    """A step's work: the batch's loss (``batch_loss``), its backward inside
    ``cudnn_fp32`` as the forward runs (cuDNN's RNN backward reads the TF32
    flag when it runs, not when its forward ran), then ``update``, each a
    span (``train.forward``, ``train.backward``, ``train.optimizer``).
    Returns the loss, detached."""
    with span("train.forward"):
        loss = batch_loss(model, data_x, idx, mask, generator, rate, loss_kind)
    with span("train.backward"):
        optimizer.zero_grad(set_to_none=True)
        with cudnn_fp32():
            loss.backward()
    with span("train.optimizer"):
        update()
    return loss.detach()


class _StepGraph:
    """One optimizer's training step as a captured CUDA graph: ``key``, what
    the capture depends on; the side stream of the warm-up and the capture;
    then the graph, and the tensors its replays read (the batch's rows and
    mask, copied in before each replay) and write (the loss)."""

    def __init__(self, key: tuple, stream):
        self.key, self.stream = key, stream
        self.graph = self.idx = self.mask = self.loss = None


# each optimizer's step graph; an entry goes with its optimizer, and holds no reference to it
_graphs: "weakref.WeakKeyDictionary[torch.optim.Optimizer, _StepGraph]" = weakref.WeakKeyDictionary()


def _graphable(model: nn.Module, optimizer: torch.optim.Optimizer, data_x: torch.Tensor, generator) -> bool:
    """Whether the step can be one captured graph: the data on the card, the
    port's Adam (the one optimizer that reads its per-step scalars from
    device memory), the model in train mode and dropout drawn from a
    generator on the card."""
    return (data_x.is_cuda and isinstance(optimizer, Adam) and model.training
            and isinstance(generator, torch.Generator) and generator.device.type == "cuda")


def _graph_key(model, optimizer, data_x, idx, mask, generator, rate, loss_kind) -> tuple:
    """What a captured step reads from where: the model, the generator,
    ``data_x``'s storage and shape, B and the dtypes of the rows and mask,
    the rate and the loss, the model's mode, and the storage of every
    parameter and of the optimizer's moments."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    moments = [optimizer.state[p].get(k) for p in params for k in ("mu", "nu")]
    return (model, generator, data_x.data_ptr(), tuple(data_x.shape), data_x.dtype, tuple(idx.shape), idx.dtype,
            mask.dtype, rate, loss_kind, model.training, tuple(p.data_ptr() for p in params),
            tuple(0 if m is None else m.data_ptr() for m in moments))


def _capture(g: _StepGraph, model, optimizer, data_x, idx, mask, generator, rate, loss_kind) -> None:
    """Captures ``_step_body`` with Adam's device half on ``g.stream``, the
    dropout generator registered so that each replay moves its offset as an
    eager step does.  The gradients are let go first, so that the backward
    makes them in the graph's own memory."""
    g.idx, g.mask = idx.clone(), mask.clone()
    optimizer.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    current = torch.cuda.current_stream(data_x.device)
    g.stream.wait_stream(current)
    with torch.cuda.stream(g.stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            g.loss = _step_body(model, optimizer, data_x, g.idx, g.mask, generator, rate, loss_kind,
                                optimizer.apply_loaded)
        finally:
            graph.capture_end()
    current.wait_stream(g.stream)
    g.graph = graph
    _counted.captures += 1


def _graphed_step(model, optimizer, data_x, idx, mask, generator, rate, loss_kind) -> torch.Tensor:
    """``train_step``'s step through the optimizer's step graph: with a key
    the graph has not seen, an eager step on a side stream (it makes the
    optimizer's state and warms cuDNN and the allocator); at the next call
    with the same key, the capture; then a replay, in which the host copies
    the batch's rows and mask in, writes Adam's per-step scalars and
    launches the graph.  The spans ``train.capture`` and ``train.replay``."""
    key = _graph_key(model, optimizer, data_x, idx, mask, generator, rate, loss_kind)
    g = _graphs.get(optimizer)
    if g is None or g.key != key:
        stream = torch.cuda.Stream(data_x.device)
        current = torch.cuda.current_stream(data_x.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            loss = _step_body(model, optimizer, data_x, idx, mask, generator, rate, loss_kind, optimizer.step)
        current.wait_stream(stream)
        loss.record_stream(current)
        _graphs[optimizer] = _StepGraph(_graph_key(model, optimizer, data_x, idx, mask, generator, rate, loss_kind),
                                        stream)
        return loss
    optimizer.load_step()
    if g.graph is None:
        with span("train.capture"):
            _capture(g, model, optimizer, data_x, idx, mask, generator, rate, loss_kind)
    with span("train.replay"):
        g.idx.copy_(idx)
        g.mask.copy_(mask)
        g.graph.replay()
        _counted.replays += 1
        return g.loss.clone()


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, data_x: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor, lr: float, generator: torch.Generator, rate: float, loss_kind: str) -> torch.Tensor:
    """One step on the batch ``data_x[idx]`` at learning rate ``lr``
    (``_step_body``); returns the batch's loss before the update, on the
    device, a tensor of its own each call.  The step is a span,
    ``train.step``.

    On the card, with the port's Adam and the model in train mode, the
    step runs as one captured CUDA graph a step (``_graphed_step``), keyed
    on what it reads: the first call with a new key is eager, the next
    captures, and every later one replays.  The results are the eager
    step's, bit for bit where its kernels are deterministic.  Counted in
    ``train_step.captures`` and ``train_step.replays``."""
    with span("train.step"):
        for group in optimizer.param_groups:
            group["lr"] = lr
        if _graphable(model, optimizer, data_x, generator):
            return _graphed_step(model, optimizer, data_x, idx, mask, generator, rate, loss_kind)
        return _step_body(model, optimizer, data_x, idx, mask, generator, rate, loss_kind, optimizer.step)


train_step.captures = 0
train_step.replays = 0
_counted = train_step  # the counters' function, whatever a caller rebinds the module's name to


def sharded_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, data_x: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor, lr: float, generator: torch.Generator, rate: float, loss_kind: str,
                       grid: Grid) -> torch.Tensor:
    """``train_step`` of the whole batch ``data_x[idx]`` with this rank's
    block of its rows (``grid.rows``): dropout drawn for the whole batch,
    this rank's share of the batch mean, its gradients and that share
    summed over the data group in one all-reduce, then the optimizer.
    Returns the batch's loss before the update, on the device.  The spans
    are ``train_step``'s; ``train.backward`` holds the all-reduce."""
    with span("train.step"):
        with span("train.forward"):
            rows = grid.rows(idx.shape[0])
            total = _weighted_total(model, data_x, idx[rows], mask[rows], RowShard(generator, idx.shape[0], rows),
                                    rate, loss_kind)
            share = total / mask.to(total.dtype).sum().clamp_min(1.0)
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=False)
            with cudnn_fp32():
                share.backward()
            params = [p for group in optimizer.param_groups for p in group["params"]]
            mean = share.detach().reshape(1)
            all_reduce_sum_([*(p.grad for p in params), mean], grid.data_group)
            if loss_kind == "rmse":  # d sqrt(m) = dm / (2 sqrt(m)): the chain rule after the sum
                torch._foreach_mul_([p.grad for p in params], 0.5 / torch.sqrt(mean[0]))
        with span("train.optimizer"):
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
        return _finalize_loss(loss_kind, mean[0], 1.0)


def validate(model: nn.Module, val_x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, loss_kind: str,
             grid: Optional[Grid] = None) -> float:
    """The loss over every unmasked row, the model in eval mode (the fused
    encoder kernel on the card) under no_grad; the model is left in train
    mode.  With ``grid``, this rank's block of each batch's rows, the
    totals summed over the data group.  A span, ``train.validate``, with
    one ``train.validate.batch`` a batch."""
    with span("train.validate"):
        sums = torch.zeros(2, device=val_x.device)  # total, count
        model.eval()
        with torch.no_grad():
            for bidx, bmask in zip(idx, mask):
                with span("train.validate.batch"):
                    if grid is not None:
                        rows = grid.rows(bidx.shape[0])
                        bidx, bmask = bidx[rows], bmask[rows]
                    x = val_x.index_select(0, bidx)
                    elem = _elementwise_loss(loss_kind, model(x), x)
                    w = bmask.to(x.dtype)[:, None, None]
                    sums = sums + torch.stack([torch.sum(elem * w), torch.sum(w) * elem.shape[1] * elem.shape[2]])
        model.train()
        if grid is not None:
            all_reduce_sum_([sums], grid.data_group)
        return float(_finalize_loss(loss_kind, sums[0], sums[1]))


def main_train(
    cfg: TrainConfig,
    arrays: Optional[ArraySet] = None,
    max_steps: Optional[int] = None,
    resume_dir: Optional[str] = None,
    device=None,
    init_params: Optional[Dict] = None,
    mesh: Optional[Grid] = None,
) -> str:
    """Train an autoencoder on ``device`` (the first CUDA device unless
    named); returns the results directory.  With ``mesh``, this rank's part
    of a run over the grid's ranks (see the module docstring); every rank
    returns rank 0's results directory.

    ``resume_dir``: a previous run's results dir of this package — the full
    train state (params + optimizer + dropout generator + step) is restored
    from its best resumable checkpoint and training continues.
    ``init_params``: the initial parameters as the JAX package's
    numpy tree (as ``model_init.npz`` holds them) in place of the seeded
    init, so that a run can start where another package's did.

    Each step's learning rate and batch rows are a span, ``train.schedule``;
    each chunk's wait for its losses ``train.readback``; its CSV and
    tracker logging ``train.log``; each checkpoint save ``train.checkpoint``.
    """
    t_start = time.time()
    np.random.seed(cfg.seed)
    require_float32(cfg)
    device = resolve_device(device)
    if mesh is not None and cfg.batch_size < mesh.data:
        raise ValueError(f"batch_size {cfg.batch_size} gives a rank no rows over {mesh.data} data ranks")
    writer = mesh is None or mesh.rank == 0  # the rank that writes files

    results_dir = None
    if writer:
        run_id = time.strftime("%y-%m-%d-%H%M%S")
        results_dir = os.path.join(cfg.results_dir, "networks_autoencoder", run_id)
        os.makedirs(results_dir, exist_ok=True)
    if mesh is not None:
        results_dir = broadcast_object(results_dir)
    logger = setup_logging(results_dir) if writer else logging.getLogger("train")
    tags = [
        cfg.model_class, f"latent_size={cfg.latent_size}", f"batch_size={cfg.batch_size}",
        f"lr={cfg.lr}", cfg.lr_scheduler_type, f"validation_interval={cfg.validation_interval}",
        f"early_stopping_patience={cfg.early_stopping_patience}", cfg.loss, cfg.optimizer_type,
        f"dropout={cfg.dropout}", f"weight_decay={cfg.weight_decay}", f"seed={cfg.seed}",
        f"dataset_dir={cfg.dataset_dir}", f"nr_train_ids={cfg.nr_train_ids}",
    ]
    tracker = make_tracker(cfg.tracker if writer else None, results_dir, tags)
    csvlog = CsvLogs(results_dir if writer else None)

    mdef = model_def(cfg.model_class)
    model = mdef.build(cfg.latent_size, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    if init_params is not None:
        model.load_jax_tree(init_params)
    model.train()
    if writer:
        with span("train.checkpoint"):
            ckpt.save_state(os.path.join(results_dir, "model_init.npz"), model.jax_tree())

    logger.info(f"Start loading data from dataset version: {cfg.dataset_dir}")
    if arrays is None:
        arrays = load_arrays(cfg.dataset_dir)
    split = None
    if writer:
        split = split_datasets(arrays.info, cfg.dataset_dir, results_dir, cfg.split_size_val, cfg.split_size_test,
                               cfg.nr_train_ids), np.random.get_state()
    if mesh is not None:  # the masks, and the stream the batch order draws from, as rank 0 left them
        split = broadcast_object(split)
        np.random.set_state(split[1])
    tr_mask, va_mask, te_mask = split[0]
    logger.info(f"Data loading done. Length of Data: {len(arrays)} samples")

    n_train = int(tr_mask.sum())
    n_val = int(va_mask.sum())
    if n_train == 0 or n_val == 0:
        raise ValueError(
            f"empty split (train={n_train}, val={n_val}, test={int(te_mask.sum())}): "
            "with few case ids the seeded patient-level draw can leave a split empty — "
            "increase the dataset, adjust split fractions, or change the seed"
        )
    epochs = effective_epochs(cfg, n_train)

    x_all = layout_waves(np.asarray(arrays.waves, np.float32), mdef.channel_first)
    train_x = torch.from_numpy(np.ascontiguousarray(x_all[tr_mask])).to(device)
    val_x = torch.from_numpy(np.ascontiguousarray(x_all[va_mask])).to(device)

    optimizer = make_optimizer(
        cfg.optimizer_type,
        model.parameters(),
        cfg.lr,
        cfg.weight_decay,
        momentum=cfg.sgd_momentum,
        ranger_momentum=cfg.ranger_momentum,
        ranger_threshold=cfg.ranger_threshold,
    )
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    resume_step = 0
    if resume_dir is not None:
        state = ckpt.load_train_state(ckpt.latest_resumable(resume_dir))
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        generator.set_state(state["generator"])
        resume_step = int(state["step"])
        logger.info(f"Resumed full train state from {resume_dir} at step {resume_step}")

    steps_per_epoch = math.ceil(n_train / cfg.batch_size)
    schedule, is_steplr = _lr_schedule(cfg, steps_per_epoch)
    val_idx, val_m = (torch.from_numpy(a).to(device) for a in
                      _batched_indices(n_val, cfg.batch_size, np.arange(n_val, dtype=np.int32)))

    # early-stopping state (run_train.py:30-103)
    patience_counter, early_stop = 0, False
    valid_loss_min = np.inf
    best_path = None
    lr_valid_counter = 0
    lr_events = 0
    global_step = resume_step

    logger.info(f"Start training with learning rate scheduler: {cfg.lr_scheduler_type}")
    V = cfg.validation_interval
    step = train_step if mesh is None else functools.partial(sharded_train_step, grid=mesh)
    for epoch in range(1, epochs + 1):
        t_epoch = time.time()
        tracker.log("epoch", epoch)
        # train_shuffle=False iterates in dataset order (DataLoader semantics);
        # val order never matters for the loss (reference default val_shuffle=False)
        perm = (
            np.random.permutation(n_train).astype(np.int32)
            if cfg.train_shuffle
            else np.arange(n_train, dtype=np.int32)
        )
        idx_all, mask_all = (torch.from_numpy(a).to(device) for a in _batched_indices(n_train, cfg.batch_size, perm))

        # chunk layout replicating "validate after local step 0, V, 2V, ...":
        local = 0
        while local < steps_per_epoch and not early_stop:
            n_steps = 1 if local == 0 else min(V, steps_per_epoch - local)
            lr_scale = torch.tensor(0.5**lr_events if is_steplr else 1.0, dtype=torch.float32)
            losses, lrs = [], []
            for j in range(n_steps):
                with span("train.schedule"):
                    lr_t = float(schedule(global_step + j) * lr_scale)
                    idx, mask = idx_all[local + j], mask_all[local + j]
                losses.append(step(model, optimizer, train_x, idx, mask, lr_t, generator, cfg.dropout, cfg.loss))
                lrs.append(lr_t)
            with span("train.readback"):
                losses = torch.stack(losses).cpu().numpy()  # the chunk's one wait for the device
            with span("train.log"):
                for j in range(n_steps):
                    s_local = local + j
                    if s_local % 10 == 0 and s_local != 0:
                        csvlog.train_step(epoch, s_local, lrs[j], float(losses[j]))
                    tracker.log("Train Loss", float(losses[j]))
                    tracker.log("Batch number", s_local)
                    tracker.log("Learning Rate", lrs[j])
            global_step += n_steps
            local += n_steps
            last_local = local - 1
            train_loss_local = float(losses[-1])
            lr_current = lrs[-1]

            if last_local % V == 0:
                val_loss = validate(model, val_x, val_idx, val_m, cfg.loss, mesh)
                logger.info(f"[Epoch: {epoch}, step: {last_local}] / lr = {lr_current}")
                logger.info(f"\tTrain loss: {train_loss_local}, \t Validation loss: {val_loss}")
                csvlog.validation(epoch, last_local, lr_current, train_loss_local, val_loss)
                tracker.log("Validation loss", val_loss)

                # StepLR plateau events (run_train.py:343-348)
                if is_steplr and cfg.lr_scheduler_val_delay > 0:
                    if val_loss >= valid_loss_min:
                        lr_valid_counter += 1
                    if lr_valid_counter == cfg.lr_scheduler_val_delay:
                        lr_events += 1
                        lr_valid_counter = 0

                # early stopping + rolling best checkpoint
                if val_loss < valid_loss_min:
                    if writer:
                        with span("train.checkpoint"):
                            state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                                     "generator": generator.get_state(), "step": global_step}
                            best_path = ckpt.save_best(results_dir, val_loss, state, params=model.jax_tree())
                    valid_loss_min = val_loss
                    patience_counter = 0
                else:
                    patience_counter += 1
                    logger.info(f"EarlyStopping counter: {patience_counter} out of {cfg.early_stopping_patience}")
                    if patience_counter >= cfg.early_stopping_patience:
                        early_stop = True
                        logger.warning(f"Early Stopping @ epoch : {epoch} / step : {last_local}")

            if max_steps is not None and global_step >= max_steps:
                early_stop = True

        logger.info(
            f"End training epoch number {epoch} from {epochs} / at {time.time() - t_epoch:.1f}s; "
            f"best validation loss = {valid_loss_min}"
        )
        if early_stop:
            break

    # final model: best params if any, else current (run_train.py:537-538)
    if writer:
        with span("train.checkpoint"):
            final_params = model.jax_tree()
            if best_path is not None:
                final_params = ckpt.load_state(best_path.replace(".npz", "_params.npz"), final_params)
            ckpt.save_state(os.path.join(results_dir, "model_autoencoder.npz"), final_params)
    logger.info(f"Training is finished. Best validation loss: {valid_loss_min}")
    logger.info(f"Execution finished and saved at: {results_dir} ({time.time() - t_start:.1f}s)")
    csvlog.close()
    tracker.close()
    return results_dir
