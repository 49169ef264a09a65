"""Entry hooks of the port (the counterparts of the JAX package's
``__graft_entry__.py``, which stays as it is) and the sharded workloads they
run.

``entry(device)``: the default ``LSTMAutoencoder``'s forward (latent 10)
and its inputs (B=128, T=320), on the card unless ``device="cpu"``.

``dryrun_multichip(n, device)``: the JAX hook's five workloads over n ranks
(``parallel/launch.py``; n CUDA devices over NCCL, or n CPU ranks over gloo
with ``device="cpu"``), each checked for finite results: the LSTM AE's
train step with Ranger and its validation, the batch split over the data
axis of a (n/2, 2) grid when n >= 4 and even, else (n, 1); the
seed-sharded GBT fit; the window-sharded device extraction; the
tensor-parallel pair on the same grid when it has a model axis; and
multi-config AE training with its config axis over the ranks.

``run_sharded(jobs, devices, backend)`` runs a list of the workloads on one
set of ranks; each workload with ``mesh=None`` in the caller's process is
the unsharded run it is held against (the tests, ``chip_smoke.py``).  A
workload builds its own grid, so one set of ranks can run several grids.
"""

from __future__ import annotations

import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.parallel import launch
from ae_waveforms_tpu_torch.parallel.mesh import Grid, data_mesh

__all__ = ["entry", "dryrun_multichip", "run_sharded", "ae_steps", "gbt_seeds", "dl_seeds", "multi_configs",
           "extraction", "tp_pair", "WORKLOADS"]


def _forward(model, x):
    with torch.no_grad():
        return model(x)


def entry(device=None):
    """(fn, (model, x)): ``fn(model, x)`` is the default LSTM autoencoder's
    eval-mode forward (its encoder on the fused kernel on the card) of x
    (128, 320, 1) float32, weights from seed 0."""
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder

    device = resolve_device(device)
    model = LSTMAutoencoder(10, generator=torch.Generator().manual_seed(0), device=device).eval()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((128, 320, 1)), dtype=torch.float32, device=device)
    return _forward, (model, x)


def ae_steps(device, mesh: Optional[Grid] = None, model_class: str = "LSTMAutoencoder", latent: int = 4,
             n_rows: int = 40, batch: int = 16, seq_len: int = 32, optimizer: str = "ranger", dropout: float = 0.2,
             loss: str = "mse", seed: int = 0, waves: Optional[np.ndarray] = None, steps: Optional[int] = None,
             timed: bool = False) -> Dict:
    """An epoch of train steps (``train.loop.train_step``, or
    ``sharded_train_step`` with ``mesh``) over ``waves`` (n_rows random
    beats of ``seq_len`` from ``seed`` when None; the last batch uneven
    where ``batch`` does not divide the rows), at most ``steps`` of them,
    then a validation over the same batches.  ``timed``: each step's ms
    from CUDA events, and with ``mesh`` an all-reduce of a buffer of the
    model's parameter count (ms, p50 of 50)."""
    from ae_waveforms_tpu_torch.bridge import tree_to_numpy
    from ae_waveforms_tpu_torch.models.registry import model_def
    from ae_waveforms_tpu_torch.train.data import layout_waves
    from ae_waveforms_tpu_torch.train.loop import _batched_indices, sharded_train_step, train_step, validate
    from ae_waveforms_tpu_torch.train.optimizers import make_optimizer

    mdef = model_def(model_class)
    if waves is None:
        waves = np.random.default_rng(seed).standard_normal((n_rows, seq_len)).astype(np.float32)
    data_x = torch.from_numpy(np.ascontiguousarray(layout_waves(np.asarray(waves, np.float32),
                                                                mdef.channel_first))).to(device)
    model = mdef.build(latent, generator=torch.Generator().manual_seed(seed), device=device).train()
    opt = make_optimizer(optimizer, model.parameters(), 1e-3, ranger_momentum=0.95, ranger_threshold=5)
    generator = torch.Generator(device=device).manual_seed(seed)
    idx, mask = (torch.from_numpy(a).to(device) for a in
                 _batched_indices(len(waves), batch, np.random.default_rng(seed + 1).permutation(len(waves))))
    losses, step_ms = [], []
    for j in range(min(len(idx), steps or len(idx))):
        if timed:
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
        args = (model, opt, data_x, idx[j], mask[j], 1e-3, generator, dropout, loss)
        losses.append(train_step(*args) if mesh is None else sharded_train_step(*args, grid=mesh))
        if timed:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
    out = dict(losses=torch.stack(losses).cpu().numpy(), val=validate(model, data_x, idx, mask, loss, mesh),
               params=tree_to_numpy(model.jax_tree()), step_ms=step_ms)
    if timed and mesh is not None:
        flat = torch.zeros(sum(p.numel() for p in model.parameters()) + 1, device=device)
        ms = []
        for _ in range(51):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            dist.all_reduce(flat, group=mesh.data_group)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        out.update(allreduce_ms=float(np.median(ms[1:])), allreduce_bytes=flat.numel() * 4)
    return out


_GBT_PARAMS = dict(max_depth=3, n_estimators=8, learning_rate=0.3, gamma=0.0, min_child_weight=1.0, subsample=0.8,
                   colsample_bytree=0.8)


def gbt_seeds(device, mesh: Optional[Grid] = None, n_seeds: int = 8, n_per: int = 150, F: int = 6, seed: int = 0,
              params: Optional[Dict] = None) -> np.ndarray:
    """The vectorized size x seed fit of ``n_seeds`` seeds (row and column
    subsampling on) on ``n_per`` synthetic rows a class: the (n_seeds,
    n_test) probabilities (``classify.harness._fit_eval_vectorized``)."""
    from ae_waveforms_tpu_torch.classify.harness import _fit_eval_vectorized, prepare_class_data

    rng = np.random.default_rng(seed)
    control = rng.standard_normal((n_per, F)).astype(np.float32)
    sick = (rng.standard_normal((n_per, F)) + 0.6).astype(np.float32)
    data = prepare_class_data(control, sick, test_size=n_per // 4)
    size = len(data.control_train) * 2 // 3
    return _fit_eval_vectorized(data, size, n_seeds, params or _GBT_PARAMS, None, mesh=mesh, device=device)


def dl_seeds(device, mesh: Optional[Grid] = None, n_seeds: int = 3, n_per: int = 60, seq_len: int = 24,
             epochs: int = 2, seed: int = 0) -> List[float]:
    """The DL classifier's size x seed sweep at one size on ``n_per``
    synthetic beats a class: the seeds' test AUCs
    (``classify.dl.dl_size_seed_sweep``, vectorized)."""
    from ae_waveforms_tpu_torch.classify.dl import dl_size_seed_sweep

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, seq_len, dtype=np.float32)
    control = (np.sin(6 * t) + 0.5 * rng.standard_normal((n_per, seq_len))).astype(np.float32)
    sick = (np.sin(6 * t + 0.8) + 0.5 * rng.standard_normal((n_per, seq_len))).astype(np.float32)
    summary = dl_size_seed_sweep(control, sick, sizes=(n_per // 2,), n_seeds=n_seeds, num_epochs=epochs,
                                 test_size=n_per // 4, vectorized=True, device=device, mesh=mesh)
    return summary[0]["aucs"]


def multi_configs(device, mesh: Optional[Grid] = None, seeds: Sequence[int] = (3, 4), n_beats: int = 96,
                  n_cases: int = 12, latent: int = 3, seq_len: int = 320, max_steps: int = 2,
                  model_class: str = "LSTMAutoencoder", seed: int = 0) -> Dict:
    """``train.multi.train_ae_multi`` of ``seeds`` on ``n_beats`` random
    beats (the JAX hook's cut): the result's histories, best losses and
    best params (numpy)."""
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.core.schema import ArraySet
    from ae_waveforms_tpu_torch.train.multi import train_ae_multi

    rng = np.random.default_rng(seed)
    waves = rng.standard_normal((n_beats, seq_len)).astype(np.float32)
    feats = rng.standard_normal((n_beats, 35)).astype(np.float32)
    case_ids = np.repeat(np.arange(1, n_cases + 1), n_beats // n_cases)
    info = np.stack([case_ids, 10000.0 * (1 + np.arange(n_beats) % 5)], axis=1)
    with tempfile.TemporaryDirectory(prefix="dryrun_multi_") as td:
        cfg = TrainConfig(dataset_dir=td, results_dir=td, model_class=model_class, latent_size=latent, batch_size=8,
                          epochs=1, validation_interval=1, split_size_val=0.25, split_size_test=0.25, lr=1e-3,
                          seed=1, plotting=False)
        res = train_ae_multi(cfg, list(seeds), arrays=ArraySet(waves=waves, features=feats, info=info),
                             max_steps=max_steps, results_dir=td, mesh=mesh, device=device)
    return dict(train_losses=res.train_losses, val_losses=res.val_losses, best_val=res.best_val,
                best_params=res.best_params)


def extraction(device, mesh: Optional[Grid] = None, n_records: int = 2, duration_s: float = 60.0,
               windows_per_batch: int = 4) -> List[Tuple]:
    """The batched device engine (float32, the device delineator) over
    ``n_records`` synthetic records in chunks of ``windows_per_batch``:
    (case id, waves, features, indices, raw windows) a case."""
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data.extract import extract_cases
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    records = {c: synthetic_ecg_record(duration_s=duration_s, seed=c) for c in range(1, n_records + 1)}
    results = extract_cases(list(records), records.get, ExtractionConfig(delineation_engine="device"), batched=True,
                            windows_per_batch=windows_per_batch, device=device, mesh=mesh)
    return [(r.case_id, r.waves, r.features, r.indices, r.n_windows_raw) for r in results]


def tp_pair(device, mesh: Grid, params: Dict[str, np.ndarray], x: np.ndarray, y: np.ndarray,
            lr: float = 0.1) -> Dict:
    """The tensor-parallel pair on ``mesh``: its forward of ``x`` and one
    SGD step on (x, y), each rank's rows and shards gathered into the whole
    output, the whole new params and the loss (numpy) on every rank."""
    from ae_waveforms_tpu_torch.parallel.tp import mlp_forward_tp, shard_mlp_params, tp_train_step

    shard = shard_mlp_params(params, mesh, device)
    xt, yt = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (x, y))
    with torch.no_grad():
        out = mlp_forward_tp(shard, xt, mesh)
    new, loss = tp_train_step(shard, xt, yt, lr, mesh)
    mine = (mesh.data_index, mesh.model_index, out.cpu().numpy(), {k: v.cpu().numpy() for k, v in new.items()},
            [tuple(v.shape) for v in shard.values()])
    parts: List = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    rows = [p[2] for p in sorted(parts, key=lambda p: p[:2]) if p[1] == 0]
    cols = [p[3] for p in sorted(parts, key=lambda p: p[:2]) if p[0] == 0]
    return dict(out=np.concatenate(rows), loss=loss, shard_shapes=sorted({s for p in parts for s in p[4]}),
                params={"w1": np.concatenate([c["w1"] for c in cols], 1), "b1": np.concatenate([c["b1"] for c in cols]),
                        "w2": np.concatenate([c["w2"] for c in cols]), "b2": cols[0]["b2"]})


WORKLOADS = {"ae": ae_steps, "gbt": gbt_seeds, "dl": dl_seeds, "multi": multi_configs, "extract": extraction,
             "tp": tp_pair}


def _launch_counts() -> Dict[str, int]:
    return dict(_build.launches)


def _jobs_rank(device, jobs) -> Dict:
    before = _launch_counts()
    results = []
    for name, model_parallel, kwargs in jobs:
        results.append(WORKLOADS[name](device, data_mesh(model_parallel), **kwargs))
    mine = {k: v - before[k] for k, v in _launch_counts().items()}
    counts: List = [None] * dist.get_world_size()
    dist.all_gather_object(counts, mine)
    return dict(results=results, launches={k: sum(c[k] for c in counts) for k in mine},
                ranks=dist.get_world_size())


def run_sharded(jobs: Sequence[Tuple[str, int, Dict]], devices: Sequence[str], backend: str,
                timeout_s: float = 600.0) -> Dict:
    """Run ``jobs`` ((workload name, model_parallel, kwargs), in order) on
    one rank a device; returns rank 0's {"results": one a job, "launches":
    the kernels' launches summed over the ranks, "ranks"}."""
    return launch.run(_jobs_rank, (list(jobs),), devices, backend, timeout_s)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0) -> Dict:
    """The JAX hook's five workloads over ``n_devices`` ranks (see the
    module docstring); returns ``run_sharded``'s result."""
    devices, backend = launch.devices_for(n_devices, device)
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    batch = max(2 * n_devices, 8)
    rng = np.random.default_rng(0)
    d_in, hidden = 8, 4 * model_parallel
    jobs = [("ae", model_parallel, dict(latent=4, n_rows=4 * batch, batch=batch, seq_len=32, steps=1)),
            ("gbt", model_parallel, dict(n_seeds=n_devices, n_per=64, F=4)),
            ("extract", 1, dict(n_records=4, windows_per_batch=max(n_devices, 2))),
            ("multi", 1, dict(seeds=list(range(3, 3 + n_devices)), latent=3))]
    if model_parallel > 1:
        params = {"w1": (rng.standard_normal((d_in, hidden)) * 0.1).astype(np.float32),
                  "b1": np.zeros(hidden, np.float32),
                  "w2": (rng.standard_normal((hidden, 1)) * 0.1).astype(np.float32), "b2": np.zeros(1, np.float32)}
        jobs.append(("tp", model_parallel, dict(params=params, x=rng.standard_normal((batch, d_in)).astype(np.float32),
                                                 y=rng.standard_normal(batch).astype(np.float32), lr=1e-2)))
    out = run_sharded(jobs, devices, backend, timeout_s)
    ae, gbt, ext, multi = out["results"][:4]
    _check(bool(np.isfinite(ae["losses"]).all()) and np.isfinite(ae["val"]), "AE step or validation not finite")
    _check(gbt.shape[0] == n_devices and bool(np.isfinite(gbt).all()), "GBT probabilities")
    _check(sum(len(c[1]) for c in ext) > 0, "the extraction kept no beat")
    _check(multi["train_losses"].shape[1] == n_devices and bool(np.isfinite(multi["train_losses"]).all()),
           "multi-config losses")
    if model_parallel > 1:
        _check(np.isfinite(out["results"][4]["loss"]), "tensor-parallel loss")
    return out


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
