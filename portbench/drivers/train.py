"""Driver ``train``: the window is one call of
``ae_waveforms_tpu_torch.train.loop.main_train(cfg, arrays, max_steps=N)``,
the call ``cli.main_ae -m train`` makes, on arrays the benchmark made from
the seed, from initial weights the benchmark drew (``init_params``).

Set-up makes the beats and the weights on the card, then makes one
``main_train`` call of ``warm_steps`` steps (with its validations) that
builds and warms every kernel and cuDNN plan of the window's shapes, and
whose last chunk gives the step rate, from which N is set so that the
timed call lasts about ``--seconds``.

The check follows the timed call's own first three steps: a wrapper of
``train.loop.train_step`` (installed from here, for the timed call only)
keeps each step's loss, the optimizer's first moment after step 1 (the
first gradient as the optimizer got it) and the parameters after step 3.
The reference re-draws the split, the batch order and the dropout masks
from the seed and takes the same three steps in float64.

It also holds the call's first validation (after step 1), which runs the
model in eval mode: for the LSTM AE the fused encoder kernel, then the
decoder.  A wrapper of ``train.loop.validate`` keeps the loss it returns,
the model's parameters at that point and, through a forward hook on the
model for that validation alone, every validation row's reconstruction.
The reference runs the eval forward in float64 from those parameters over
the validation rows it re-draws from the seed.  It starts from the
program's parameters because Adam's first step moves each weight by about
the learning rate times the sign of its gradient, so the round-off of the
near-zero gradients reaches the weights at the size of a TF32 error; the
steps that make those parameters are held by the numbers above.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data
from portbench.bench import Comparison, Measured
from portbench.counts import flops
from portbench.reference import ae as ref_ae
from portbench.reference import split as ref_split

CHECKED_STEPS = 3
ALTERED = 0.1  # the planted fault's change to one validation row's latent
BETA1 = 0.9
# every number the check can compare; a cell's traffic file gives the limit of each it compares
NUMBERS = ("loss_gap", "loss0_gap", "grad_gap", "grad_med", "change_gap", "change_med", "val_loss_gap",
           "val_recon_gap")


@dataclass
class Recorder:
    """Wraps ``train_step``: counts the steps, keeps every loss (on the
    device), what the check needs from the first three steps, and opens
    and closes the traced sub-window at steps ``trace_steps``."""

    tracer: Any = None
    trace_steps: tuple = (0, 0)
    count: int = 0
    losses: List[torch.Tensor] = field(default_factory=list)
    start: Dict[str, torch.Tensor] = field(default_factory=dict)
    first_moment: Dict[str, torch.Tensor] = field(default_factory=dict)
    end: Dict[str, torch.Tensor] = field(default_factory=dict)
    timed_step: int = -1
    timed_at: float = 0.0  # host clock as step ``timed_step`` is issued
    val_loss: float = float("nan")  # the first validation's loss, its parameters and reconstructions
    val_params: Dict[str, Dict[str, torch.Tensor]] = None
    val_out: List[torch.Tensor] = field(default_factory=list)
    k3: bool = False  # whether a validation launches K3 (the LSTM AE's fused encoder)
    k3_rows: List[int] = field(default_factory=list)  # rows of each such launch in the traced sub-window

    def wrap(self, step):
        def recorded(model, optimizer, *args, **kwargs):
            k = self.count
            if k == self.timed_step:
                self.timed_at = time.perf_counter()
            if self.tracer is not None:
                if k == self.trace_steps[0]:
                    self.tracer.start()
                elif k == self.trace_steps[1]:
                    self.tracer.stop()
            if k == 0:
                self.start = _leaves(model, lambda p: p.detach().clone())
            loss = step(model, optimizer, *args, **kwargs)
            self.losses.append(loss)
            if k == 0:
                self.first_moment = _leaves(model, lambda p: _first_moment(optimizer, p).clone())
            if k == CHECKED_STEPS - 1:
                self.end = _leaves(model, lambda p: p.detach().clone())
            self.count += 1
            return loss

        return recorded

    def wrap_validate(self, validate):
        def recorded(model, val_x, idx, *args, **kwargs):
            if self.k3 and self.tracer is not None and self.tracer.active:
                self.k3_rows.extend([idx.shape[1]] * idx.shape[0])
            if self.val_params is not None:
                return validate(model, val_x, idx, *args, **kwargs)
            self.val_params = {k: {n: p.detach().clone() for n, p in leaves.items()}
                               for k, leaves in model.jax_tree().items()}
            hook = model.register_forward_hook(lambda module, inputs, out: self.val_out.append(out.detach().clone()))
            try:
                self.val_loss = validate(model, val_x, idx, *args, **kwargs)
            finally:
                hook.remove()
            return self.val_loss

        return recorded


def _leaves(model, fn) -> Dict[str, torch.Tensor]:
    return {f"{layer}.{name}": fn(p) for layer, leaves in model.jax_tree().items() for name, p in leaves.items()}


def _first_moment(optimizer, p) -> torch.Tensor:
    state = optimizer.state[p]
    for key in ("mu", "exp_avg"):
        if key in state:
            return state[key]
    raise KeyError(f"the optimizer's state holds no first moment: {sorted(state)}")


@dataclass
class State:
    arrays: Any
    init: Dict[str, Dict[str, torch.Tensor]]
    steps: int
    case_ids: np.ndarray
    waves: np.ndarray
    recorder: Recorder = None


def _config(bench, results_dir: str):
    from ae_waveforms_tpu_torch.core.config import TrainConfig

    c, t = bench.cell.config, bench.cell.traffic
    return TrainConfig(
        dataset_dir=os.path.join(results_dir, "data"), results_dir=results_dir, seed=bench.seed % 2**32,
        model_class=c["model_class"], latent_size=c["latent_size"], batch_size=c["batch_size"],
        split_size_val=c["split_size_val"], split_size_test=c["split_size_test"],
        validation_interval=c["validation_interval"], loss=c["loss"], dropout=c["dropout"], lr=c["lr"],
        optimizer_type=c["optimizer"], lr_scheduler_type=c["lr_scheduler"], epochs=c["epochs"], plotting=False,
    )


def setup(bench) -> State:
    from ae_waveforms_tpu_torch.core.schema import ArraySet
    from ae_waveforms_tpu_torch.train import loop

    c, t = bench.cell.config, bench.cell.traffic
    dev = bench.device
    n = t["beats"]
    waves = data.beats(n, data.generator(dev, bench.seed, 1), dev).cpu().numpy()
    ids = data.case_ids(n, t["case_ids"])
    arrays = ArraySet(waves=waves, features=np.zeros((n, c["features"])),
                      info=np.stack([ids, np.arange(n, dtype=np.float64) * 10_000], 1))
    init = data.uniform_tree(data.model_shapes(c), data.generator(dev, bench.seed, 2), dev)
    V = c["validation_interval"]
    warm = t["warm_steps"]
    rec = Recorder(timed_step=warm - V)
    step = loop.train_step
    loop.train_step = rec.wrap(step)
    try:
        loop.main_train(_config(bench, bench.scratch_dir("warm")), arrays, max_steps=warm, device=dev,
                        init_params=init)
        bench.synchronize()
    finally:
        loop.train_step = step
    rate = V / (time.perf_counter() - rec.timed_at)  # steps/s of the last chunk and its validation
    steps = 1 + V * max(1, round((bench.seconds * rate - 1) / V))
    print(f"portbench: warm-up {warm} steps, {rate:.1f} steps/s at the end; the window takes {steps}",
          file=sys.stderr)
    bench.tracer.warm()
    return State(arrays=arrays, init=init, steps=steps, case_ids=ids, waves=waves)


def _beats_trained(steps: int, n_train: int, batch: int) -> int:
    """Beats in the first ``steps`` steps: full batches, save each epoch's
    last, which holds the rest of the training rows."""
    per_epoch = -(-n_train // batch)
    epochs, rest = divmod(steps, per_epoch)
    return epochs * n_train + rest * batch


def measure(state: State, bench) -> Measured:
    from ae_waveforms_tpu_torch.train import loop

    c, t = bench.cell.config, bench.cell.traffic
    rec = Recorder(tracer=bench.tracer if bench.trace else None, trace_steps=tuple(t["trace_steps"]),
                   k3=c["model_class"] == "LSTMAutoencoder")
    state.recorder = rec
    step, validate = loop.train_step, loop.validate
    loop.train_step, loop.validate = rec.wrap(step), rec.wrap_validate(validate)
    try:
        t0 = time.perf_counter()
        loop.main_train(_config(bench, bench.scratch_dir("timed")), state.arrays, max_steps=state.steps,
                        device=bench.device, init_params=state.init)
        bench.synchronize()
        wall = time.perf_counter() - t0
    finally:
        loop.train_step, loop.validate = step, validate
        bench.tracer.stop()
    train_rows, _ = ref_split.train_rows_and_order(state.case_ids, bench.seed % 2**32, c["split_size_val"],
                                                   c["split_size_test"])
    beats = _beats_trained(rec.count, len(train_rows), c["batch_size"])
    failed = int((~torch.isfinite(torch.stack(rec.losses))).sum()) if rec.losses else 0
    return Measured(attempted=rec.count, failed=failed, end_to_end={"train_beats_per_s": beats / wall},
                    records={"model_flops": beats * flops.train_per_beat(c), "wall_s": wall, "steps": rec.count,
                             "k3_rows": rec.k3_rows})


def _widths(c):
    return c.get("hidden_sizes") if c["model_class"] == "LSTMAutoencoder" else c.get("channels")


def reference_steps(bench, case_ids: np.ndarray, waves: np.ndarray, init, dtype, weights=None, steps=CHECKED_STEPS):
    """The reference's first ``steps`` steps: losses, first gradients, final
    parameters (flat leaf names)."""
    c = bench.cell.config
    dev = bench.device
    seed = bench.seed % 2**32
    rows, order = ref_split.train_rows_and_order(case_ids, seed, c["split_size_val"], c["split_size_test"])
    B = c["batch_size"]
    conv = c["model_class"] != "LSTMAutoencoder"
    batches = []
    for k in range(steps):
        x = torch.from_numpy(waves[rows[order[k * B:(k + 1) * B]]]).to(dev)
        batches.append(x[:, None, :] if conv else x[:, :, None])
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ref_ae.dropout_shapes(c["model_class"], B, c["beat_length"], _widths(c))
    keeps = [ref_ae.keep_masks(gen, shapes, c["dropout"], dev) for _ in range(steps)]
    losses, grads, end = ref_ae.train_steps(c["model_class"], init, batches, keeps, c["dropout"], c["lr"], dtype,
                                            weights)
    flat = lambda tree: {f"{k}.{n}": v for k, layer in tree.items() for n, v in layer.items()}  # noqa: E731
    return losses, flat(grads), flat(end)


def gaps(losses, grads, end, start, ref_losses, ref_grads, ref_end, ref_start) -> Dict[str, float]:
    """The numbers the check may compare: the relative gap of the first
    step's loss and the largest over the three steps; of each leaf's
    first-gradient norm, and of each leaf's change over the steps, the gap
    taken against the reference's norm of the leaf or of the median leaf,
    whichever is larger, the largest over the leaves and the median.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change (Adam moves them by rounding alone)."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    g_ref = {k: norm(v) for k, v in ref_grads.items()}
    g_med = float(np.median(list(g_ref.values())))
    grad = [abs(norm(grads[k]) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref]
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: norm(ref_end[k].double() - ref_start[k].double()) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    change = [abs(norm(end[k].double() - start[k].double()) - d_ref[k]) / max(d_ref[k], d_med) for k in moved]
    return {"loss_gap": max(loss), "loss0_gap": loss[0], "grad_gap": max(grad), "grad_med": float(np.median(grad)),
            "change_gap": max(change), "change_med": float(np.median(change))}


def validation_rows(bench, case_ids: np.ndarray, waves: np.ndarray) -> torch.Tensor:
    """The validation rows, in the model's layout, on the device, in the
    trainer's order (ascending)."""
    c = bench.cell.config
    _, rows, _ = ref_split.split_rows(case_ids, bench.seed % 2**32, c["split_size_val"], c["split_size_test"])
    x = torch.from_numpy(waves[rows]).to(bench.device)
    return x[:, None, :] if c["model_class"] != "LSTMAutoencoder" else x[:, :, None]


def validation_gaps(loss: float, recon: torch.Tensor, ref_recon: torch.Tensor, x: torch.Tensor) -> Dict[str, float]:
    """The relative gap of the validation loss (the mean squared error over
    every validation value), and the largest gap of a row's reconstruction,
    its norm taken against the reference row's norm or the median row's,
    whichever is larger."""
    ref_loss = float(((ref_recon - x.to(ref_recon.dtype)) ** 2).mean())
    n = len(ref_recon)
    diff = torch.linalg.vector_norm((recon.reshape(n, -1).double() - ref_recon.reshape(n, -1).double()), dim=1)
    size = torch.linalg.vector_norm(ref_recon.reshape(n, -1).double(), dim=1)
    worst = float((diff / torch.clamp(size, min=float(size.median()))).max())
    return {"val_loss_gap": abs(loss - ref_loss) / ref_loss, "val_recon_gap": worst}


def check(state: State, bench, measured: Measured) -> List[Comparison]:
    rec = state.recorder
    if rec is None or rec.count < CHECKED_STEPS:
        return [Comparison("steps_checked", float("inf"), 0.0)]
    if rec.val_params is None:
        return [Comparison("validations_checked", float("inf"), 0.0)]
    program = dict(losses=[float(x) for x in rec.losses[:CHECKED_STEPS]],
                   grads={k: v / (1.0 - BETA1) for k, v in rec.first_moment.items()},
                   end=rec.end, start=rec.start)
    state.arrays = None
    rec.losses = []
    torch.cuda.empty_cache() if bench.device.type == "cuda" else None
    ref_losses, ref_grads, ref_end = reference_steps(bench, state.case_ids, state.waves, state.init, torch.float64)
    ref_start = {f"{k}.{n}": v for k, layer in state.init.items() for n, v in layer.items()}
    readings = gaps(program["losses"], program["grads"], program["end"], program["start"], ref_losses, ref_grads,
                    ref_end, ref_start)
    x = validation_rows(bench, state.case_ids, state.waves)
    recon = torch.cat(rec.val_out)[: len(x)]
    ref_recon = ref_ae.reconstruct(bench.cell.config["model_class"], rec.val_params, x, torch.float64)
    readings.update(validation_gaps(rec.val_loss, recon, ref_recon, x))
    limits = bench.cell.traffic["limits"]
    return [Comparison(k, readings[k], limit) for k, limit in limits.items()]


def altered_row(z: torch.Tensor) -> torch.Tensor:
    """The planted fault: the first row's latent moved by ``ALTERED``."""
    z = z.clone()
    z[0] += ALTERED
    return z


def control_readings(bench) -> Dict[str, Dict[str, float]]:
    """The numbers the check compares, read from the reference put in the
    program's place in the precision below the configuration's (float32
    with TF32 on), from the reference with half of each batch left out
    (the mean over the rest), and from a step that leaves the state as it
    was, each against the float64 reference.  The control's validation
    runs the reference's eval forward in float32 with TF32 on from the
    parameters the float64 reference has after its first step; the fault
    ``altered`` runs it in float64 with the first validation row's latent
    moved by ``ALTERED`` where the encoder makes it."""
    c, t = bench.cell.config, bench.cell.traffic
    dev = bench.device
    n = t["beats"]
    waves = data.beats(n, data.generator(dev, bench.seed, 1), dev).cpu().numpy()
    ids = data.case_ids(n, t["case_ids"])
    init = data.uniform_tree(data.model_shapes(c), data.generator(dev, bench.seed, 2), dev)
    start = {f"{k}.{m}": v for k, layer in init.items() for m, v in layer.items()}
    ref = reference_steps(bench, ids, waves, init, torch.float64)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        control = reference_steps(bench, ids, waves, init, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    B = c["batch_size"]
    half = torch.cat([torch.ones(B // 2), torch.zeros(B - B // 2)]).to(dev)
    halved = reference_steps(bench, ids, waves, init, torch.float64, weights=[half] * CHECKED_STEPS)
    out = {}
    for name, (losses, grads, end) in (("control", control), ("half_batch", halved),
                                       ("unchanged", (ref[0], ref[1], start))):
        out[name] = gaps(losses, grads, end, start, *ref, start)
    x = validation_rows(bench, ids, waves)
    after_one = reference_steps(bench, ids, waves, init, torch.float64, steps=1)[2]
    params = {}
    for key, p in after_one.items():
        layer, leaf = key.split(".", 1)
        params.setdefault(layer, {})[leaf] = p
    ref_recon = ref_ae.reconstruct(c["model_class"], params, x, torch.float64)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        recon = ref_ae.reconstruct(c["model_class"], params, x, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    out["control"].update(validation_gaps(float(((recon.double() - x.double()) ** 2).mean()), recon, ref_recon, x))
    recon = ref_ae.reconstruct(c["model_class"], params, x, torch.float64, block=len(x), alter=altered_row)
    out["altered"] = validation_gaps(float(((recon - x.double()) ** 2).mean()), recon, ref_recon, x)
    return out
