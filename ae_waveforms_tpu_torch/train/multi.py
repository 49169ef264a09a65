"""Multi-configuration AE training (the port of the JAX package's
``train/multi.py``): S configurations of one architecture trained together
on one device, their parameters stacked on a leading config axis
(``train/stacked.py``).

Semantics follow the JAX package: the one-step warm chunk, then
validation every ``validation_interval`` steps of an epoch (an epoch's
final partial segment does not validate; run_train.py:317-319); early
stopping with the best snapshot kept, the stop checked only on validations
that did not improve (:335-340); StepLR halving on validation plateaus, the
counter reading the minimum before the update and reset only when it fires
(:343-348); an optional learning-rate multiplier a config.  All configs
share ONE split drawn from ``cfg.seed`` unless ``per_config_splits``, which
redraws the patient split under each config's seed and cuts every config's
train and validation rows to the smallest count (the JAX package's
size-equalised membership).  Batch order comes from
``np.random.default_rng(seed)`` a config, as in the JAX package; init and
dropout from ``torch.Generator``s seeded with the config's seed (``init``
injects another package's parameters).

Segments are grouped into dispatches as the JAX package groups them (up to
``segments_per_dispatch`` consecutive segments of one length and one
validation flag); ``max_steps``, the all-stopped check and
``checkpoint_every`` act after a dispatch, so a run takes the JAX
package's steps.  One divergence: a configuration that has stopped drops
out of the steps after it (the JAX package trains it on, its best snapshot
frozen), so its train and validation losses after it are NaN here.

``checkpoint_every=K`` writes the whole train state (stacked parameters and
snapshot, the optimizer's state, every config's dropout generator, the
counters, the histories and the loop position) every K dispatches,
atomically; ``resume_dir`` continues from it bit for bit.  The format is
the port's own (``torch.save`` bytes in an ``.npz``, beside the JAX
package's ``.meta.json``): the JAX package's state holds ``jax.random``
keys and optax state, so neither package resumes the other's.

With ``mesh`` (a ``parallel.mesh.Grid``), the config axis is split over the
grid's data axis in contiguous blocks: rank 0 draws the split (and writes
its masks) and hands it to the others, each rank trains its block as one
run of its own (its checkpoints tagged with its data index, the memory cap
applied to its block), and the blocks' results are gathered in config
order on every rank, where rank 0 writes the run dirs.  Every config has
its own generators and batch order, so the split changes no result.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ae_waveforms_tpu_torch import cudnn_fp32, resolve_device
from ae_waveforms_tpu_torch.bridge import tree_to_numpy
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, load_arrays
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.parallel.mesh import Grid, broadcast_object, gather_blocks
from ae_waveforms_tpu_torch.train import checkpoint as ckpt
from ae_waveforms_tpu_torch.train.data import draw_split_masks, layout_waves, split_datasets
from ae_waveforms_tpu_torch.train.loop import (
    _batched_indices,
    _lr_schedule,
    batch_loss,
    effective_epochs,
    require_float32,
    validate,
)
from ae_waveforms_tpu_torch.train.optimizers import make_optimizer
from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

__all__ = ["train_ae_multi", "train_ae_multi_grouped", "MultiTrainResult", "stack_trees", "unstack_tree",
           "multi_step"]


def stack_trees(trees: Sequence[Dict]) -> Dict:
    """S JAX-named trees of arrays -> one tree of (S, ...) arrays."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def unstack_tree(tree: Dict) -> List[Dict]:
    """A tree of (S, ...) arrays -> S trees."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    return [pick(tree, i) for i in range(len(leaf))]


@dataclass
class MultiTrainResult:
    """Stacked (leading config axis) outcome of one multi-config run."""

    seeds: List[int]
    best_params: dict  # JAX-named tree of (S, ...) numpy arrays
    best_val: np.ndarray  # (S,) best validation loss per config
    ever_improved: np.ndarray  # (S,) whether a best snapshot was ever taken
    stopped: np.ndarray  # (S,) early-stopped flags at exit
    train_losses: np.ndarray  # (total_steps, S), NaN after a config stopped
    val_losses: np.ndarray  # (n_validations, S), NaN after a config stopped
    run_dirs: Optional[List[str]] = None  # per-config run dirs (save_runs=True)
    lr_multipliers: Optional[np.ndarray] = None  # (S,) per-config lr scale

    def params_for(self, i: int):
        return unstack_tree(self.best_params)[i]


def multi_step(stacked: StackedConfigs, optimizer: torch.optim.Optimizer, active: Sequence[int],
               data_x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, lrs: Sequence[float], generators,
               rate: float, loss_kind: str) -> torch.Tensor:
    """One step of every ``active`` config: its batch loss
    (``train.loop.batch_loss``) and backward (inside ``cudnn_fp32``, as
    ``train.loop.train_step``), then one optimizer step over every config's
    param group at its learning rate ``lrs[s]``.  Returns the (S,) losses
    before the update, NaN for the configs left out, on the device."""
    stacked.zero_grad()
    losses = []
    for s in active:
        loss = batch_loss(stacked.bound(s), data_x, idx[s], mask[s], generators[s], rate, loss_kind)
        with cudnn_fp32():
            loss.backward()
        losses.append(loss.detach())
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    optimizer.step()
    out = torch.full((stacked.S,), float("nan"), dtype=data_x.dtype, device=data_x.device)
    if losses:  # every config may have stopped before the dispatch ends
        out[torch.as_tensor(np.asarray(active, np.int64), device=data_x.device)] = torch.stack(losses)
    return out


def _config_axis_cap(model_class: str, latent: int, batch: int, n_rows: int, seq_len: int) -> int:
    """Most configs of the LSTM autoencoder that fit the card at once
    (``core/hbm.py``; the dataset is held once for every config).  The
    conv family has no recurrent working set and is not capped, as in the
    JAX package."""
    if "LSTM" not in model_class:
        return 0
    from ae_waveforms_tpu_torch.core.hbm import seed_axis_cap

    hidden = (128, 64, latent, 64, 128, 1)
    p_count = sum(p.numel() for p in model_def(model_class).build(latent, device="meta").parameters())
    return seed_axis_cap(0, 0, seq_len, batch, hidden, p_count, shared_bytes=4 * n_rows * seq_len)


def _merge_multi_results(parts: List[MultiTrainResult]) -> MultiTrainResult:
    """Concatenate per-group results into one study (groups that stopped
    sooner NaN-pad their history tails)."""
    def padcat(arrs: List[np.ndarray]) -> np.ndarray:
        L = max(a.shape[0] for a in arrs)
        return np.concatenate([np.pad(a.astype(np.float32), ((0, L - a.shape[0]), (0, 0)), constant_values=np.nan)
                               for a in arrs], axis=1)

    trees = [t for p in parts for t in unstack_tree(p.best_params)]
    return MultiTrainResult(
        seeds=[s for p in parts for s in p.seeds],
        best_params=stack_trees(trees),
        best_val=np.concatenate([p.best_val for p in parts]),
        ever_improved=np.concatenate([p.ever_improved for p in parts]),
        stopped=np.concatenate([p.stopped for p in parts]),
        train_losses=padcat([p.train_losses for p in parts]),
        val_losses=padcat([p.val_losses for p in parts]),
        run_dirs=None if parts[0].run_dirs is None else [d for p in parts for d in p.run_dirs],
        lr_multipliers=np.concatenate([p.lr_multipliers for p in parts]),
    )


def _draw_split(cfg: TrainConfig, arrays: ArraySet, seeds: Sequence[int], per_config_splits: bool,
                mask_dir: str) -> Dict:
    """The configs' patient split: with ``per_config_splits`` each config's
    own draw under its seed (no files), its train and validation rows cut
    to the smallest count of any config; else one split for every config,
    drawn from ``cfg.seed`` as ``main_train`` draws it, its masks written
    to ``mask_dir``."""
    if per_config_splits:
        # the sequential study's draw under each seed (np.random.seed, then the patient-level split)
        per_masks = []
        for s_ in seeds:
            np.random.seed(s_)
            per_masks.append(draw_split_masks(arrays.info[:, 0], cfg.split_size_val, cfg.split_size_test,
                                              cfg.nr_train_ids))
        n_train = min(int(m["train"].sum()) for m in per_masks)
        n_val = min(int(m["val"].sum()) for m in per_masks)
        split = dict(per_masks=per_masks, n_train=n_train, n_val=n_val,
                     train_rows=np.stack([np.flatnonzero(m["train"])[:n_train] for m in per_masks]).astype(np.int32),
                     val_rows=np.stack([np.flatnonzero(m["val"])[:n_val] for m in per_masks]).astype(np.int32))
    else:
        np.random.seed(cfg.seed)
        tr_mask, va_mask, _ = split_datasets(arrays.info, cfg.dataset_dir, mask_dir, cfg.split_size_val,
                                             cfg.split_size_test, cfg.nr_train_ids)
        split = dict(tr_mask=tr_mask, va_mask=va_mask, n_train=int(tr_mask.sum()), n_val=int(va_mask.sum()))
    if split["n_train"] == 0 or split["n_val"] == 0:
        raise ValueError(f"empty split (train={split['n_train']}, val={split['n_val']})")
    return split


def _split_block(split: Dict, rows: slice) -> Dict:
    """The configs ``rows`` of a ``_draw_split`` split."""
    return {k: v[rows] if k in ("per_masks", "train_rows", "val_rows") else v for k, v in split.items()}


def _per_cfg_masks(split: Dict, n: int) -> List[dict]:
    """Each config's train, validation and test masks over the n rows of a
    per-config split (its cut rows, its own test draw)."""
    out = []
    for s in range(len(split["per_masks"])):
        m = {k: np.zeros(n, bool) for k in ("train", "val")}
        m["train"][split["train_rows"][s]] = True
        m["val"][split["val_rows"][s]] = True
        m["test"] = split["per_masks"][s]["test"]
        out.append(m)
    return out


def _multi_ckpt_paths(dir_: str, latent_size: int, tag: str = "") -> Tuple[str, str]:
    # keyed by latent size and group tag, so grouped runs in one results_dir keep their own
    base = os.path.join(dir_, f"multi_checkpoint_d{latent_size}{tag}")
    return base + ".npz", base + ".meta.json"


def _save_multi_ckpt(dir_: str, state: Dict, meta: dict) -> None:
    """Write the train state and its meta file, each through a temporary
    file and a rename, so a kill mid-write leaves the previous pair."""
    npz_path, meta_path = _multi_ckpt_paths(dir_, meta["latent_size"], meta.get("tag", ""))
    buf = io.BytesIO()
    torch.save(state, buf)
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, torch_state=np.frombuffer(buf.getvalue(), np.uint8))
    os.replace(tmp, npz_path)
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def _load_multi_ckpt(dir_: str, fingerprint: dict, latent_size: int, tag: str) -> Tuple[Dict, dict]:
    """A ``_save_multi_ckpt`` state, its tensors on the CPU, after checking
    that it was written by the same study."""
    npz_path, meta_path = _multi_ckpt_paths(dir_, latent_size, tag)
    with open(meta_path) as f:
        meta = json.load(f)
    for k, v in fingerprint.items():
        if meta.get(k) != v:
            raise ValueError(f"multi checkpoint mismatch on {k!r}: saved {meta.get(k)!r}, this run {v!r} — "
                             "refusing to resume a different study")
    with np.load(npz_path, allow_pickle=False) as z:
        if "torch_state" not in z.files:
            raise ValueError(f"{npz_path} holds no multi-config train state of this package")
        raw = z["torch_state"].tobytes()
    return torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True), meta


def train_ae_multi(
    cfg: TrainConfig,
    seeds: Sequence[int],
    arrays: Optional[ArraySet] = None,
    lr_multipliers: Optional[Sequence[float]] = None,
    max_steps: Optional[int] = None,
    segments_per_dispatch: int = 8,
    results_dir: Optional[str] = None,
    save_runs: bool = False,
    per_config_splits: bool = False,
    checkpoint_every: Optional[int] = None,
    resume_dir: Optional[str] = None,
    max_config_chunk: Optional[int] = None,
    device=None,
    init_params: Optional[Dict] = None,
    mesh: Optional[Grid] = None,
    _ckpt_tag: str = "",
    _split: Optional[Dict] = None,
) -> MultiTrainResult:
    """Train ``len(seeds)`` configurations of ``cfg.model_class`` at
    ``cfg.latent_size`` together on ``device`` (the first CUDA device
    unless named); see the module docstring for the semantics.

    ``lr_multipliers`` scales each configuration's learning rate.
    ``max_steps`` bounds the step count (checked after a dispatch).
    ``save_runs`` writes each configuration to its own
    ``<cfg.results_dir>/networks_autoencoder/<stamp>-d<latent>-s<seed>[-lr<mult>]``
    run dir (the best params and the split masks), which ``main_test`` and
    ``Scorer.from_run`` read as they read a ``main_train`` run.
    ``results_dir`` holds the split masks and the multi checkpoints
    (a temporary directory when None).  ``max_config_chunk``: most configs
    trained at once; a wider call splits into balanced groups trained one
    after another (None: ``core.hbm``'s cap on a CUDA device, none on the
    CPU; 0: none).  ``init_params``: the configs' initial parameters as
    one JAX-named tree of (S, ...) arrays.  ``mesh``: this rank's part of
    a run whose config axis is split over the grid's ranks (see the module
    docstring); every rank returns the whole result.  ``_split``: the
    split of these configs drawn by the caller (``_draw_split``)."""
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    if S == 0:
        raise ValueError("need at least one seed")
    lr_mults = [float(m) for m in lr_multipliers] if lr_multipliers is not None else [1.0] * S
    if len(lr_mults) != S:
        raise ValueError("lr_multipliers must match seeds")
    if checkpoint_every is not None and results_dir is None:
        raise ValueError("checkpoint_every needs results_dir (checkpoint home)")
    require_float32(cfg)
    device = resolve_device(device)
    mdef = model_def(cfg.model_class)
    if arrays is None:
        arrays = load_arrays(cfg.dataset_dir)

    if mesh is not None:
        writer = mesh.rank == 0
        mask_dir = (results_dir or tempfile.mkdtemp(prefix="ae_multi_")) if writer else None
        if writer:
            os.makedirs(mask_dir, exist_ok=True)
        split = broadcast_object(_draw_split(cfg, arrays, seeds, per_config_splits, mask_dir) if writer else None)
        rows = mesh.rows(S)
        part = None
        if rows.stop > rows.start:
            part = train_ae_multi(
                cfg, seeds[rows], arrays=arrays, lr_multipliers=lr_mults[rows], max_steps=max_steps,
                segments_per_dispatch=segments_per_dispatch, results_dir=results_dir,
                per_config_splits=per_config_splits, checkpoint_every=checkpoint_every, resume_dir=resume_dir,
                max_config_chunk=max_config_chunk, device=device,
                init_params=None if init_params is None else stack_trees(unstack_tree(init_params)[rows]),
                _ckpt_tag=f"{_ckpt_tag}-r{mesh.data_index}", _split=_split_block(split, rows))
        result = _merge_multi_results([p for p in gather_blocks(part, mesh) if p is not None])
        if save_runs:
            run_dirs = None
            if writer:
                per_cfg = _per_cfg_masks(split, len(arrays.info)) if per_config_splits else None
                run_dirs = _save_multi_runs(cfg, result, mask_dir, per_cfg_masks=per_cfg)
            result.run_dirs = broadcast_object(run_dirs)
        return result

    if max_config_chunk is None:
        max_config_chunk = 0
        if device.type == "cuda":
            with torch.cuda.device(device):
                max_config_chunk = _config_axis_cap(cfg.model_class, cfg.latent_size, cfg.batch_size,
                                                    len(arrays.info), int(arrays.waves.shape[1]))
    if max_config_chunk and S > max_config_chunk:
        n_groups = math.ceil(S / max_config_chunk)
        base, extra = divmod(S, n_groups)
        inits = None if init_params is None else unstack_tree(init_params)
        parts, o = [], 0
        for gi, size in enumerate([base + 1] * extra + [base] * (n_groups - extra)):
            sl = slice(o, o + size)
            o += size
            parts.append(train_ae_multi(
                cfg, seeds[sl], arrays=arrays, lr_multipliers=lr_mults[sl], max_steps=max_steps,
                segments_per_dispatch=segments_per_dispatch, results_dir=results_dir, save_runs=save_runs,
                per_config_splits=per_config_splits, checkpoint_every=checkpoint_every, resume_dir=resume_dir,
                max_config_chunk=0, device=device, init_params=None if inits is None else stack_trees(inits[sl]),
                _ckpt_tag=f"{_ckpt_tag}-g{gi}", _split=None if _split is None else _split_block(_split, sl)))
        return _merge_multi_results(parts)

    mask_dir = results_dir or tempfile.mkdtemp(prefix="ae_multi_")
    os.makedirs(mask_dir, exist_ok=True)
    split = _split if _split is not None else _draw_split(cfg, arrays, seeds, per_config_splits, mask_dir)
    n_train, n_val = split["n_train"], split["n_val"]
    train_rows, val_rows = split.get("train_rows"), split.get("val_rows")

    x_all = layout_waves(np.asarray(arrays.waves, np.float32), mdef.channel_first)
    if per_config_splits:  # one copy of the dataset; each config gathers its own rows by absolute index
        train_x = val_x = torch.from_numpy(np.ascontiguousarray(x_all)).to(device)
    else:
        train_x = torch.from_numpy(np.ascontiguousarray(x_all[split["tr_mask"]])).to(device)
        val_x = torch.from_numpy(np.ascontiguousarray(x_all[split["va_mask"]])).to(device)

    models = []
    inits = None if init_params is None else unstack_tree(init_params)
    for i, s_ in enumerate(seeds):
        m = mdef.build(cfg.latent_size, generator=torch.Generator().manual_seed(s_), device="cpu")
        if inits is not None:
            m.load_jax_tree(inits[i])
        models.append(m)
    stacked = StackedConfigs(mdef.build(cfg.latent_size, device=device).train(), models, device)
    optimizer = make_optimizer(cfg.optimizer_type, stacked.param_groups(), cfg.lr, cfg.weight_decay,
                               momentum=cfg.sgd_momentum, ranger_momentum=cfg.ranger_momentum,
                               ranger_threshold=cfg.ranger_threshold)
    generators = [torch.Generator(device=device).manual_seed(s_) for s_ in seeds]

    steps_per_epoch = math.ceil(n_train / cfg.batch_size)
    schedule, is_steplr = _lr_schedule(cfg, steps_per_epoch)
    lr_mult = np.asarray(lr_mults, np.float32)

    # early-stop and plateau carries, one entry a config
    best = stacked.snapshot()
    best_val = np.full(S, np.inf)
    patience_ctr = np.zeros(S, np.int64)
    lr_valid_ctr = np.zeros(S, np.int64)
    lr_events = np.zeros(S, np.int64)
    stopped = np.zeros(S, bool)
    ever_improved = np.zeros(S, bool)

    if per_config_splits:
        pairs = [_batched_indices(n_val, cfg.batch_size, val_rows[s]) for s in range(S)]
    else:
        pairs = [_batched_indices(n_val, cfg.batch_size, np.arange(n_val, dtype=np.int32))] * S
    val_idx = [torch.from_numpy(p[0]).to(device) for p in pairs]
    val_m = [torch.from_numpy(p[1]).to(device) for p in pairs]

    host_rngs = [np.random.default_rng(s_) for s_ in seeds]
    epochs = effective_epochs(cfg, n_train)
    V = cfg.validation_interval
    fingerprint = dict(seeds=seeds, lr_mults=lr_mults, model_class=cfg.model_class, latent_size=cfg.latent_size,
                       batch_size=cfg.batch_size, n_train=n_train)

    train_hist: List[np.ndarray] = []
    val_hist: List[np.ndarray] = []
    global_step = 0
    start_epoch, start_b0 = 1, 0
    if resume_dir is not None:
        state, meta = _load_multi_ckpt(resume_dir, fingerprint, cfg.latent_size, _ckpt_tag)
        stacked.load_(state["params"])
        for name, t in best.items():
            t.copy_(state["best"][name])
        optimizer.load_state_dict(state["optimizer"])
        for g, g_state in zip(generators, state["generators"]):
            g.set_state(g_state)
        best_val, patience_ctr, lr_valid_ctr, lr_events, stopped, ever_improved = (
            state["carries"][k].numpy().copy() for k in
            ("best_val", "patience_ctr", "lr_valid_ctr", "lr_events", "stopped", "ever_improved"))
        start_epoch, start_b0, global_step = meta["epoch"], meta["next_b0"], meta["global_step"]
        train_hist = [state["thist"].numpy()]
        val_hist = [state["vhist"].numpy()]

    done = bool(max_steps is not None and global_step >= max_steps)
    n_dispatches = 0
    for epoch in range(1, epochs + 1):
        if done:
            break
        # every config's permutation, drawn in every epoch, so a resumed run's streams replay the ones it skips
        perms = [rng.permutation(n_train).astype(np.int32) if cfg.train_shuffle
                 else np.arange(n_train, dtype=np.int32) for rng in host_rngs]
        if epoch < start_epoch:
            continue
        batches = [_batched_indices(n_train, cfg.batch_size, perms[s] if train_rows is None
                                    else train_rows[s][perms[s]]) for s in range(S)]
        idx_all = torch.from_numpy(np.stack([b[0] for b in batches], axis=1)).to(device)  # (steps, S, B)
        mask_all = torch.from_numpy(np.stack([b[1] for b in batches], axis=1)).to(device)

        # segments "validate after local step 0, V, 2V, ...": one that ends on a V multiple validates
        bounds = [(0, 1)]
        local = 1
        while local < steps_per_epoch:
            n = min(V, steps_per_epoch - local)
            bounds.append((local, n))
            local += n
        do_vals = [((lo + n - 1) % V) == 0 for lo, n in bounds]

        b0 = start_b0 if epoch == start_epoch else 0
        while b0 < len(bounds) and not done:
            # a dispatch: consecutive segments of one length and one validation flag
            b1 = b0
            while (b1 < len(bounds) and bounds[b1][1] == bounds[b0][1] and do_vals[b1] == do_vals[b0]
                   and b1 - b0 < segments_per_dispatch):
                b1 += 1
            losses, vlosses = [], []
            for lo, n in bounds[b0:b1]:
                active = np.flatnonzero(~stopped)
                lr_scale = lr_mult * np.float32(0.5) ** lr_events.astype(np.float32) if is_steplr else lr_mult
                scale = torch.from_numpy(lr_scale.astype(np.float32))
                for j in range(n):
                    lrs = (schedule(global_step + j) * scale).tolist()
                    losses.append(multi_step(stacked, optimizer, active, train_x, idx_all[lo + j], mask_all[lo + j],
                                             lrs, generators, cfg.dropout, cfg.loss))
                global_step += n
                if not do_vals[b0]:
                    continue
                val = np.full(S, np.nan)
                for s in active:
                    val[s] = validate(stacked.bound(s), val_x, val_idx[s], val_m[s], cfg.loss)
                vlosses.append(val)
                act = ~stopped
                if is_steplr and cfg.lr_scheduler_val_delay > 0:
                    lr_valid_ctr = np.where(act & (val >= best_val), lr_valid_ctr + 1, lr_valid_ctr)
                    fire = act & (lr_valid_ctr == cfg.lr_scheduler_val_delay)
                    lr_events = np.where(fire, lr_events + 1, lr_events)
                    lr_valid_ctr = np.where(fire, 0, lr_valid_ctr)
                improved = act & (val < best_val)
                stacked.take_(best, torch.from_numpy(improved))
                best_val = np.where(improved, val, best_val)
                ever_improved |= improved
                patience_ctr = np.where(improved, 0, np.where(act, patience_ctr + 1, patience_ctr))
                stopped = stopped | (act & ~improved & (patience_ctr >= cfg.early_stopping_patience))
            train_hist.append(torch.stack(losses).cpu().numpy())
            if vlosses:
                val_hist.append(np.stack(vlosses).astype(np.float32))
            b0 = b1
            done = bool(stopped.all()) or (max_steps is not None and global_step >= max_steps)
            n_dispatches += 1
            if checkpoint_every is not None and n_dispatches % checkpoint_every == 0:
                carries = dict(best_val=best_val, patience_ctr=patience_ctr, lr_valid_ctr=lr_valid_ctr,
                               lr_events=lr_events, stopped=stopped, ever_improved=ever_improved)
                state = dict(params={k: v.cpu() for k, v in stacked.snapshot().items()},
                             best={k: v.cpu() for k, v in best.items()}, optimizer=optimizer.state_dict(),
                             generators=[g.get_state() for g in generators],
                             carries={k: torch.from_numpy(np.asarray(v)) for k, v in carries.items()},
                             thist=torch.from_numpy(np.concatenate(train_hist) if train_hist
                                                    else np.zeros((0, S), np.float32)),
                             vhist=torch.from_numpy(np.concatenate(val_hist) if val_hist
                                                    else np.zeros((0, S), np.float32)))
                _save_multi_ckpt(mask_dir, state, dict(fingerprint, epoch=epoch, next_b0=b0, global_step=global_step,
                                                       per_config_splits=per_config_splits, tag=_ckpt_tag))

    # a config whose validation never improved keeps its final params (run_train.py:537-538)
    stacked.take_(best, torch.from_numpy(~ever_improved))
    result = MultiTrainResult(
        seeds=seeds,
        best_params=stack_trees([tree_to_numpy(stacked.module_of(s, best).jax_tree()) for s in range(S)]),
        best_val=best_val.astype(np.float32),
        ever_improved=ever_improved,
        stopped=stopped,
        train_losses=np.concatenate(train_hist, axis=0) if train_hist else np.zeros((0, S), np.float32),
        val_losses=np.concatenate(val_hist, axis=0) if val_hist else np.zeros((0, S), np.float32),
        lr_multipliers=lr_mult,
    )
    if save_runs:
        per_cfg = _per_cfg_masks(split, len(arrays.info)) if per_config_splits else None
        result.run_dirs = _save_multi_runs(cfg, result, mask_dir, per_cfg_masks=per_cfg)
    return result


def _save_multi_runs(cfg: TrainConfig, result: MultiTrainResult, mask_dir: str,
                     per_cfg_masks: Optional[List[dict]] = None) -> List[str]:
    """One ``main_train``-shaped run dir a configuration: its best params
    under the rolling-best file name ``latest_best`` globs for, and the
    split masks (``indices_{split}_*.npy``) ``main_test`` reads: the shared
    set this run wrote in ``mask_dir`` (the newest of each split, since a
    reused results_dir can hold older ones), or each config's own with
    ``per_cfg_masks``.  The optimizer's state is not written: use
    ``checkpoint_every`` / ``resume_dir`` to resume mid-run."""
    stamp = time.strftime("%y-%m-%d-%H%M%S")
    masks = []
    for split in ("train", "val", "test"):
        cands = glob.glob(os.path.join(mask_dir, f"indices_{split}_*.npy"))
        if cands:
            masks.append(max(cands, key=os.path.getmtime))
    mults = result.lr_multipliers
    tag_lr = mults is not None and not np.allclose(mults, 1.0)
    dirs: List[str] = []
    seen: Dict[str, int] = {}
    for i, seed in enumerate(result.seeds):
        name = f"{stamp}-d{cfg.latent_size}-s{seed}"
        if tag_lr:  # lr-sweep configs share seeds; the multiplier tells them apart
            name += f"-lr{float(mults[i]):g}"
        n_prev = seen.get(name, 0)  # duplicate configs (--seeds 3,3) get distinct dirs
        seen[name] = n_prev + 1
        if n_prev:
            name += f"-i{n_prev}"
        run_dir = os.path.join(cfg.results_dir, "networks_autoencoder", name)
        os.makedirs(run_dir, exist_ok=True)
        # a config whose validation never ran has best_val inf: its file says 'final' (its final params)
        val = "final" if not result.ever_improved[i] else float(np.around(result.best_val[i], 4))
        ckpt.save_state(os.path.join(run_dir, f"model_min_val_loss-{val}_params.npz"), result.params_for(i))
        if per_cfg_masks is not None:
            date = time.strftime("%y%m%d")
            for split, m_arr in per_cfg_masks[i].items():
                np.save(os.path.join(run_dir, f"indices_{split}_{date}"), m_arr)
        else:
            for m in masks:
                dest = os.path.join(run_dir, os.path.basename(m))
                if os.path.abspath(m) != os.path.abspath(dest):
                    shutil.copy2(m, dest)
        dirs.append(run_dir)
    return dirs


def train_ae_multi_grouped(cfg: TrainConfig, configs: Sequence[Tuple], **kwargs) -> Dict[int, MultiTrainResult]:
    """``train_ae_multi`` over configurations of several latent sizes: one
    group a latent size (their parameters differ in shape).  Each config is
    ``(latent_size, seed)`` or ``(latent_size, seed, lr_multiplier)``;
    returns ``{latent_size: MultiTrainResult}``; ``kwargs`` go to
    ``train_ae_multi``."""
    groups: Dict[int, Tuple[List[int], List[float]]] = {}
    for c in configs:
        seeds, mults = groups.setdefault(int(c[0]), ([], []))
        seeds.append(int(c[1]))
        mults.append(float(c[2]) if len(c) > 2 else 1.0)
    return {latent: train_ae_multi(replace(cfg, latent_size=latent), seeds, lr_multipliers=mults, **kwargs)
            for latent, (seeds, mults) in groups.items()}
