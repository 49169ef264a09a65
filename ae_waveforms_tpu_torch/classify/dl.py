"""End-to-end deep classifier harness (the port of the JAX package's
``classify/dl.py``; capability twin of main_dl_classify.py).

Raw median beats (the first 12,000 of each class), a fixed test tail of
250 + 250, and for each training size x 25 seeds: a stratified 80/20 split
(``classify.split``, sklearn's rows), the LSTM classifier trained with
Adam (1e-4, torch's defaults, in the JAX harness's order of operations),
the learning rate halved at epochs 50 and 100, BCE on probabilities clipped
to [1e-7, 1 - 1e-7], batches of 512, up to 153 epochs with AUC-based early
stopping (patience 50, min_delta 5e-4); the best-AUC weights are restored
and scored on the fixed test set.

The seeds of a chunk train together (``train/stacked.py``): one step runs
each seed's forward and backward in turn, then one optimizer step over all
of them; validation AUC (tie-corrected, ``harness._roc_auc_device``) is
read once an epoch.  A seed stops at the epoch its counter reaches the
patience, as ``train_classifier`` of the JAX package stops, and drops out
of the steps after it.  The JAX package's vectorized path trains a stopped
seed on to the end of its 17-epoch block; that changes nothing it returns
except for a seed that never improved (validation AUC never above
``min_delta``), whose fallback there is its params at the block's end and
here its params at its stopping epoch.

Epoch permutations come from ``np.random.default_rng(seed)``, drawn as the
JAX package draws them, so every seed trains on the same rows in the same
order.  Init and dropout draw from ``torch.Generator``s seeded with the
seed, which cannot give ``jax.random``'s numbers; ``init`` injects another
package's.

With ``mesh`` (a ``parallel.mesh.Grid``) a call's seeds are split over the
grid's data axis in contiguous blocks; each rank trains its block and the
models are gathered in seed order on every rank.  A seed's training reads
nothing of another's, so the split changes no result.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.bridge import classifier_to_numpy
from ae_waveforms_tpu_torch.classify.harness import _roc_auc_device, roc_auc_score
from ae_waveforms_tpu_torch.classify.split import train_test_split
from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
from ae_waveforms_tpu_torch.parallel.mesh import Grid, gather_blocks
from ae_waveforms_tpu_torch.train.checkpoint import save_state
from ae_waveforms_tpu_torch.train.loop import _batched_indices
from ae_waveforms_tpu_torch.train.profiling import span
from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

__all__ = ["train_classifier", "train_classifier_multi", "dl_size_seed_sweep", "predict", "DL_SIZES", "NUM_EPOCHS"]

DL_SIZES = [100, 250, 500, 750, 1000, 2000, 3000, 4000, 6000, 10000, 11500]
NUM_EPOCHS = 153
DROPOUT_RATE = 0.2
HIDDEN_SIZES = (128, 64, 64)  # LSTMClassifier's LSTM widths, for the memory model

Tree = Dict
Init = Callable[[int], Tuple[Tree, Tree]]  # seed -> (params, BatchNorm state), JAX-named numpy trees


def _multistep_lr(epoch: int, base: float = 1e-4) -> float:
    return base * (0.5 ** ((epoch >= 50) + (epoch >= 100)))


class _Adam(torch.optim.Optimizer):
    """Adam at torch's defaults (betas 0.9, 0.999, eps 1e-8, no weight
    decay) in the JAX harness's order of operations: m = b1 m + (1-b1) g,
    v = b2 v + ((1-b2) g) g, p - lr (m / bc1) / (sqrt(v / bc2) + eps),
    the bias corrections in float32.  One chain of foreach ops over every
    group's tensors (a group a seed: its step count, so its bias
    corrections, are its own); parameters without a gradient are left as
    they are."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2, eps = 0.9, 0.999, 1e-8
        ps, bc1, bc2, lrs = [], [], [], []
        for group in self.param_groups:
            gps = [p for p in group["params"] if p.grad is not None]
            if not gps:
                continue
            for p in gps:
                state = self.state[p]
                if not state:
                    state.update(step=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
                state["step"] += 1
            t = np.float32(self.state[gps[0]]["step"])
            ps += gps
            bc1 += [float(np.float32(1) - np.float32(b1) ** t)] * len(gps)
            bc2 += [float(np.float32(1) - np.float32(b2) ** t)] * len(gps)
            lrs += [float(np.float32(group["lr"]))] * len(gps)
        if not ps:
            return
        gs = [p.grad for p in ps]
        m = [self.state[p]["m"] for p in ps]
        v = [self.state[p]["v"] for p in ps]
        torch._foreach_copy_(m, torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(gs, 1 - b1)))
        torch._foreach_copy_(v, torch._foreach_add(torch._foreach_mul(v, b2),
                                                   torch._foreach_mul(torch._foreach_mul(gs, 1 - b2), gs)))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
        torch._foreach_sub_(ps, torch._foreach_mul(upd, lrs))


def batch_bce(model, x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
              generator: torch.Generator, rate: float, remat_chunk: Optional[int]) -> torch.Tensor:
    """The masked mean BCE of the batch ``x[idx]`` through ``model`` in
    train mode, the probabilities clipped to [1e-7, 1 - 1e-7] (a padded
    batch's rows enter the BatchNorm statistics, as in the JAX package)."""
    bx, by, w = x.index_select(0, idx), y.index_select(0, idx), mask.to(x.dtype)
    probs = model(bx, rate, generator, remat_chunk)[:, 0].clamp(1e-7, 1 - 1e-7)
    bce = -(by * torch.log(probs) + (1 - by) * torch.log(1 - probs))
    return (bce * w).sum() / w.sum().clamp_min(1.0)


def stacked_step(stacked: StackedConfigs, optimizer: torch.optim.Optimizer, active: Sequence[int], x, y, idx, mask,
                 generators, rate: float, remat_chunk: Optional[int]) -> None:
    """One training step of every ``active`` seed: its forward and
    backward (inside ``cudnn_fp32``: cuDNN's RNN backward reads the TF32
    flag when it runs) on its batch ``x[s][idx[s]]``, then one optimizer
    step over all of them.  Spans: ``dl.step`` around it all, ``dl.seed``
    a seed's forward and backward, ``dl.optimizer`` the step."""
    with span("dl.step"):
        stacked.zero_grad()
        for s in active:
            with span("dl.seed"):
                loss = batch_bce(stacked.bound(s), x[s], y[s], idx[s], mask[s], generators[s], rate, remat_chunk)
                with cudnn_fp32():
                    loss.backward()
        with span("dl.optimizer"):
            optimizer.step()


def _models(seeds, init: Optional[Init]) -> List[LSTMClassifier]:
    models = []
    for s in seeds:
        m = LSTMClassifier(generator=torch.Generator().manual_seed(int(s)), device="cpu")
        if init is not None:
            m.load_jax_tree(*init(int(s)))
        models.append(m)
    return models


def _train_chunk(Xs, ys, Xvs, yvs, seeds, num_epochs, batch_size, patience, min_delta, remat_chunk, device,
                 init: Optional[Init], dropout_rate: float):
    """Trains the seeds together; returns the stacked configs and the
    best snapshot (``StackedConfigs.snapshot`` form)."""
    S, n = ys.shape
    template = LSTMClassifier(device=device).train()
    stacked = StackedConfigs(template, _models(seeds, init), device)
    optimizer = _Adam(stacked.param_groups(), lr=_multistep_lr(0))
    generators = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    x, y, xv, yv = put(Xs), put(ys), put(Xvs), put(yvs)
    v_valid = torch.ones(yv.shape[1], dtype=torch.bool, device=device)
    host_rngs = [np.random.default_rng(int(s)) for s in seeds]
    steps = math.ceil(n / batch_size)

    best = stacked.snapshot()
    best_auc = np.zeros(S)
    no_improve = np.zeros(S, np.int64)
    ever = np.zeros(S, bool)
    for epoch in range(num_epochs):
        active = np.flatnonzero(no_improve < patience)
        if len(active) == 0:
            break
        pairs = [_batched_indices(n, batch_size, rng.permutation(n).astype(np.int32)) for rng in host_rngs]
        idx = torch.as_tensor(np.stack([p[0] for p in pairs]), device=device)  # (S, steps, B)
        mask = torch.as_tensor(np.stack([p[1] for p in pairs]), device=device)
        for group in optimizer.param_groups:
            group["lr"] = _multistep_lr(epoch)
        for j in range(steps):
            stacked_step(stacked, optimizer, active, x, y, idx[:, j], mask[:, j], generators, dropout_rate,
                         remat_chunk)
        with span("dl.validate"):
            template.eval()
            with torch.no_grad():
                aucs = torch.stack([_roc_auc_device(stacked.bound(s)(xv[s])[:, 0], yv[s], v_valid) for s in active])
            template.train()
            auc = np.zeros(S)
            auc[active] = aucs.cpu().numpy()  # the epoch's one wait for the device
        with span("dl.select"):
            improved = np.zeros(S, bool)
            improved[active] = auc[active] - best_auc[active] > min_delta
            stacked.take_(best, torch.as_tensor(improved))
            best_auc = np.where(improved, auc, best_auc)
            ever |= improved
            no_improve = np.where(no_improve >= patience, no_improve, np.where(improved, 0, no_improve + 1))
    # a seed that never improved keeps its final params
    stacked.take_(best, torch.as_tensor(~ever))
    return stacked, best


def train_classifier_multi(
    Xs: np.ndarray,  # (S, n, T, 1)
    ys: np.ndarray,  # (S, n)
    Xvs: np.ndarray,  # (S, m, T, 1)
    yvs: np.ndarray,  # (S, m)
    seeds,
    num_epochs: int = NUM_EPOCHS,
    batch_size: int = 512,
    patience: int = 50,
    min_delta: float = 5e-4,
    remat_chunk: Optional[int] = None,
    max_seed_chunk: Optional[int] = None,
    device=None,
    init: Optional[Init] = None,
    dropout_rate: float = DROPOUT_RATE,
    mesh: Optional[Grid] = None,
):
    """All seeds trained together on ``device`` (the first CUDA device
    unless named); see the module docstring.  Returns one (params, state)
    pair of JAX-named numpy trees a seed.  With ``mesh``, this rank trains
    its block of the seeds and every rank returns every seed's pair.

    ``max_seed_chunk``: most seeds trained at once; a wider call splits
    into balanced groups trained one after another, each seed's result
    unchanged.  None takes ``core.hbm.seed_axis_cap`` of this call's shapes
    on a CUDA device and no cap on the CPU; 0 is no cap."""
    device = resolve_device(device)
    seeds = [int(s) for s in seeds]
    if mesh is not None:
        rows = mesh.rows(len(seeds))
        part = []
        if rows.stop > rows.start:
            part = train_classifier_multi(Xs[rows], ys[rows], Xvs[rows], yvs[rows], seeds[rows], num_epochs=num_epochs,
                                          batch_size=batch_size, patience=patience, min_delta=min_delta,
                                          remat_chunk=remat_chunk, max_seed_chunk=max_seed_chunk, device=device,
                                          init=init, dropout_rate=dropout_rate)
        return [m for p in gather_blocks(part, mesh) for m in p]
    if max_seed_chunk is None:
        max_seed_chunk = 0
        if device.type == "cuda":
            from ae_waveforms_tpu_torch.core.hbm import seed_axis_cap

            with torch.cuda.device(device):
                max_seed_chunk = seed_axis_cap(Xs.shape[1], Xvs.shape[1], Xs.shape[2], batch_size, HIDDEN_SIZES,
                                               _param_count(), remat_chunk=remat_chunk or 0)
    train_kw = dict(batch_size=batch_size, patience=patience, min_delta=min_delta, remat_chunk=remat_chunk,
                    device=device, init=init, dropout_rate=dropout_rate)
    if max_seed_chunk and len(seeds) > max_seed_chunk:
        n_groups = math.ceil(len(seeds) / max_seed_chunk)
        base, extra = divmod(len(seeds), n_groups)
        parts, o = [], 0
        for size in [base + 1] * extra + [base] * (n_groups - extra):
            sl = slice(o, o + size)
            o += size
            parts.append(train_classifier_multi(Xs[sl], ys[sl], Xvs[sl], yvs[sl], seeds[sl], num_epochs=num_epochs,
                                                max_seed_chunk=0, **train_kw))
        return [m for p in parts for m in p]
    stacked, best = _train_chunk(Xs, ys, Xvs, yvs, seeds, num_epochs, **train_kw)
    return [classifier_to_numpy(stacked.module_of(s, best)) for s in range(len(seeds))]


def _param_count() -> int:
    return sum(p.numel() for p in LSTMClassifier(device="meta").parameters())


def train_classifier(X_train, y_train, X_val, y_val, seed: int, num_epochs: int = NUM_EPOCHS,
                     batch_size: int = 512, patience: int = 50, min_delta: float = 5e-4, device=None,
                     init: Optional[Init] = None, dropout_rate: float = DROPOUT_RATE) -> Tuple[Tree, Tree]:
    """One seed (``train_classifier_multi`` with S = 1); returns the best
    (params, state) by validation AUC as JAX-named numpy trees."""
    return train_classifier_multi(np.asarray(X_train)[None], np.asarray(y_train)[None], np.asarray(X_val)[None],
                                  np.asarray(y_val)[None], [seed], num_epochs=num_epochs, batch_size=batch_size,
                                  patience=patience, min_delta=min_delta, max_seed_chunk=0, device=device, init=init,
                                  dropout_rate=dropout_rate)[0]


def predict(models: Sequence[Tuple[Tree, Tree]], X: np.ndarray, device=None) -> np.ndarray:
    """Each model's eval-mode probabilities (S, n) on the rows ``X`` (n, T,
    1); ``models`` are (params, state) pairs as ``train_classifier_multi``
    returns them."""
    device = resolve_device(device)
    model = LSTMClassifier(device=device).eval()
    x = torch.as_tensor(np.asarray(X, np.float32), device=device)
    out = []
    with torch.no_grad():
        for params, state in models:
            model.load_jax_tree(params, state)
            out.append(model(x)[:, 0])
    return torch.stack(out).cpu().numpy()


def dl_size_seed_sweep(
    control_waves: np.ndarray,
    sick_waves: np.ndarray,
    sizes=tuple(DL_SIZES),
    n_seeds: int = 25,
    num_epochs: int = NUM_EPOCHS,
    out_dir: Optional[str] = None,
    save_models: bool = False,
    test_size: int = 250,
    vectorized: bool = False,
    seed_chunk: int = 25,
    remat_chunk: Optional[int] = None,
    device=None,
    init: Optional[Init] = None,
    dropout_rate: float = DROPOUT_RATE,
    mesh: Optional[Grid] = None,
) -> List[Dict]:
    """The full size x seed harness on raw beats; returns summary records
    and, with ``out_dir``, writes ``size_{n}/aucs_size_{n}.csv`` and
    ``summary_auc_stats.csv`` (and ``size_{n}/model_seed_{s}.npz`` with
    ``save_models``), as the JAX package does.

    ``vectorized`` trains the seeds of a size in chunks of ``seed_chunk``
    together; without it, one after another.  Each seed's data, schedule
    and result are the same either way.  ``mesh`` splits each chunk's
    seeds over the grid's ranks (and implies ``vectorized``); every rank
    returns the records, rank 0 alone prints and writes files."""
    device = resolve_device(device)
    vectorized = vectorized or mesh is not None
    writer = mesh is None or mesh.rank == 0
    control = np.asarray(control_waves)[:, :, None].astype(np.float32)
    sick = np.asarray(sick_waves)[:, :, None].astype(np.float32)
    ts = min(test_size, len(control) - 1, len(sick) - 1)
    X_test = np.concatenate([control[-ts:], sick[-ts:]], axis=0)
    y_test = np.concatenate([np.zeros(ts), np.ones(ts)])
    control_train, sick_train = control[:-ts], sick[:-ts]
    kw = dict(num_epochs=num_epochs, remat_chunk=remat_chunk, device=device, init=init, dropout_rate=dropout_rate,
              mesh=mesh)

    summary = []
    for size in sizes:
        size = min(size, len(control_train), len(sick_train))

        def seed_data(seed):
            rng = np.random.default_rng(seed + 42)
            idx_c = rng.choice(len(control_train), size, replace=False)
            idx_s = rng.choice(len(sick_train), size, replace=False)
            X = np.concatenate([control_train[idx_c], sick_train[idx_s]], axis=0)
            yv = np.concatenate([np.zeros(size), np.ones(size)])
            return train_test_split(X, yv, test_size=0.2, stratify=yv, random_state=seed)

        chunks = ([list(range(c0, min(c0 + seed_chunk, n_seeds))) for c0 in range(0, n_seeds, seed_chunk)]
                  if vectorized else [[s] for s in range(n_seeds)])
        aucs = []
        for chunk in chunks:
            per = [seed_data(s) for s in chunk]
            models = train_classifier_multi(
                np.stack([p[0] for p in per]), np.stack([p[2] for p in per]), np.stack([p[1] for p in per]),
                np.stack([p[3] for p in per]), chunk, **kw)
            preds = predict(models, X_test, device=device)
            for i, s in enumerate(chunk):
                aucs.append(roc_auc_score(y_test, preds[i]))
                if save_models and out_dir and writer:
                    save_state(os.path.join(out_dir, f"size_{size}", f"model_seed_{s}.npz"),
                               {"params": models[i][0], "state": models[i][1]})
        rec = {"size": size, "median_auc": float(np.median(aucs)), "q1": float(np.percentile(aucs, 25)),
               "q3": float(np.percentile(aucs, 75)), "aucs": aucs}
        summary.append(rec)
        if not writer:
            continue
        print(f"Size: {size}, Median AUC: {rec['median_auc']:.4f}, IQR: ({rec['q1']:.4f}, {rec['q3']:.4f})")
        if out_dir:
            os.makedirs(os.path.join(out_dir, f"size_{size}"), exist_ok=True)
            with open(os.path.join(out_dir, f"size_{size}", f"aucs_size_{size}.csv"), "w", newline="") as f:
                wr = csv.writer(f)
                wr.writerow(["seed", "auc"])
                for s, a in enumerate(aucs):
                    wr.writerow([s, a])
    if out_dir and writer:
        with open(os.path.join(out_dir, "summary_auc_stats.csv"), "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["size", "median_auc", "q1", "q3"])
            for r in summary:
                wr.writerow([r["size"], r["median_auc"], r["q1"], r["q3"]])
    return summary

