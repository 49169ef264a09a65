"""Driver ``dl_sweep``: the window is one call of
``ae_waveforms_tpu_torch.classify.dl.dl_size_seed_sweep(control, sick,
sizes=(size,), n_seeds=S, num_epochs=E, vectorized=True, seed_chunk=S,
remat_chunk=None)``, the call ``cli.classify deep --vectorized`` makes, on
beats the benchmark made from the seed and from initial weights it drew
from the seed (``init``), for the traffic's ``epochs``.  The call splits
each seed's rows, trains the seeds together in stacked steps, reads each
epoch's validation AUC, keeps the best snapshot, and scores the returned
models on the test rows.  Its work is every row of every active seed's
stacked steps, over the call's whole wall time.

Set-up makes the beats and the weights on the card and makes the same
call for one epoch of one seed.  A seed's shapes are the same whatever the
number of seeds (B rows a step, the validation rows, the test rows), so
that builds every cuDNN plan the window uses.

Wrappers of the module's ``train_classifier_multi``, ``stacked_step``,
``batch_bce``, ``_roc_auc_device`` and ``predict`` (installed from here,
for the call alone) pass the configuration's batch size, patience and
``min_delta`` into the call, so that one value drives the program and the
reference, and keep what the check needs: each seed's rows as the sweep
split them; the first three stacked steps' losses; the first step's
gradients, and its last-LSTM outputs and the gradient that flows into them
(a wrapper of ``lstm_forward`` in ``models/lstm_classifier.py`` for that
step); the parameters and BatchNorm state after the third step; each
epoch's validation AUCs and the parameters and state they were read on;
the returned models and their test probabilities.

The check holds these to the float64 reference (``reference/classifier.py``),
``check_block`` seeds at a time:

- the first three steps from the same weights on the same batches (an
  epoch's order is ``np.random.default_rng(seed).permutation`` of the
  seed's rows, padded to whole batches with row 0, as the port draws it),
  the dropout masks drawn from each seed's generator: ``loss_gap``,
  ``grad_gap``, ``grad_med``, ``change_gap``, ``bn_gap``;
- each part of the first step from the program's own inputs to it:
  ``lstm_gap``, the last LSTM's outputs (the LSTMs' forward);
  ``lstm_grad_gap``, the LSTMs' parameter gradients against the
  reference's LSTM backward from the gradient the program fed into the last
  LSTM's outputs (the LSTMs' backward); ``head_grad_gap``, the gradients of
  the parameters after the LSTMs against the reference's head fed the
  program's last-LSTM outputs (attention, BatchNorm, the dense layers);
- the epochs: ``select_err``, the seeds whose returned model is not, bit
  for bit, the parameters and state of the epoch that the early-stopping
  rule, replayed on the program's validation AUCs, keeps; ``val_auc_err``,
  the program's validation AUC of that epoch against the AUC of the
  reference's probabilities from those parameters on the seed's
  validation rows;
- the test pass: ``prob_gap``, the returned models' test probabilities
  against the reference's from the same models; ``auc_err``, the reported
  test AUCs against the AUCs of the reference's probabilities.

Which rows a seed trains on is the port's stratified split, held to
scikit-learn's by the CPU tests.

The numbers downstream of the BatchNorm (the losses, gradients, changes
and running statistics) carry its cancellation: the pooled features of a
batch lie close together against their size, so float32's rounding of
the LSTMs' outputs, taken up by (pooled - mean) / std, moves these
numbers by up to a thousand times more on one run's data and weights than
on another's (``traffic/lstm_classifier.sweep.json``).  ``lstm_gap``,
``lstm_grad_gap`` and ``head_grad_gap`` each hold one part's own rounding
and do not swing so.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import data
from portbench.bench import Comparison, Measured
from portbench.counts import classifier as counts
from portbench.drivers.train import gaps
from portbench.reference import classifier as ref

CHECKED_STEPS = 3
WARM_SEEDS = 1  # set-up's call: a seed's shapes are those of every seed
VAL_BLOCK = 1  # seeds a reference block of the validation rows (4,600 rows x 320 steps in float64 a seed)
ALTERED = 0.1  # the planted fault's change to the first row's pooled features
T_CENTRE, T_WIDTH = 210.0, data.WAVE_WIDTHS[4]  # the T wave's mean centre and width, in samples
WRAPPED = ("train_classifier_multi", "stacked_step", "batch_bce", "_roc_auc_device", "predict")
LAST_LSTM = "lstm3"
# every number the check can compare; a cell's traffic file gives the limit of each it compares
NUMBERS = ("loss_gap", "grad_gap", "grad_med", "change_gap", "bn_gap", "lstm_gap", "lstm_grad_gap", "head_grad_gap",
           "select_err", "val_auc_err", "prob_gap", "auc_err")
_LEAF = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh", "bias_ih_l0": "b_ih", "bias_hh_l0": "b_hh", "weight": "w",
         "bias": "b"}


def ref_name(name: str) -> str:
    """A stacked parameter's torch name (``lstm1.weight_ih_l0``) as the
    reference's (``lstm1.w_ih``)."""
    layer, _, leaf = name.rpartition(".")
    return f"{layer}.{_LEAF[leaf]}" if layer else name


def _copies(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {ref_name(n): t.detach().clone() for n, t in tensors.items()}


def training(config) -> Dict[str, Any]:
    """The configuration's values that ``train_classifier_multi`` takes."""
    return {"batch_size": config["batch_size"], "patience": config["patience"], "min_delta": config["min_delta"]}


@dataclass
class Recorder:
    """Wraps the module's functions for one sweep call (``installed``):
    passes ``training`` into the seeds' training, counts the stacked steps
    and the beats they train, keeps what the check needs, and opens and
    closes the traced sub-window at steps ``trace_steps``."""

    training: Dict[str, Any]
    tracer: Any = None
    trace_steps: tuple = (-1, -1)
    count: int = 0  # stacked steps
    seed_steps: int = 0
    beats: int = 0  # Σ over stacked steps of active seeds x unpadded rows
    val_rows: int = 0  # rows of the epochs' validation passes
    chunks: int = 0
    n_train: int = 0
    n_val: int = 0
    inputs: Any = None  # (Xs, ys, Xvs, yvs, seeds) as the sweep passed them
    losses: List[torch.Tensor] = field(default_factory=list)  # every seed-step's loss, in order, on the device
    grads: Dict[str, torch.Tensor] = field(default_factory=dict)  # the first step's, (S, ...) a leaf
    lstm3: List[torch.Tensor] = field(default_factory=list)  # the first step's last-LSTM outputs, a seed's (B, T, H)
    upstream: List[torch.Tensor] = field(default_factory=list)  # the gradient that flowed into them, a seed's
    end: Dict[str, torch.Tensor] = field(default_factory=dict)  # parameters and buffers after step CHECKED_STEPS
    snapshots: List[Dict[str, torch.Tensor]] = field(default_factory=list)  # an epoch's, as its validation read them
    val_aucs: List[torch.Tensor] = field(default_factory=list)  # every validation AUC, in the order they were read
    models: Any = None
    preds: Any = None

    @property
    def batch(self) -> int:
        return self.training["batch_size"]

    def train_classifier_multi(self, fn):
        def recorded(Xs, ys, Xvs, yvs, seeds, **kwargs):
            self.chunks += 1
            self.inputs = (Xs, ys, Xvs, yvs, [int(s) for s in seeds])
            self.n_train, self.n_val = ys.shape[1], yvs.shape[1]
            self.models = fn(Xs, ys, Xvs, yvs, seeds, **kwargs, **self.training)
            return self.models

        return recorded

    def stacked_step(self, fn):
        def recorded(stacked, optimizer, active, *args):
            k = self.count
            steps = -(-self.n_train // self.batch)
            if self.tracer is not None:
                if k == self.trace_steps[0]:
                    self.tracer.start()
                elif k == self.trace_steps[1]:
                    self.tracer.stop()
            with self.last_lstm(stacked.template) if k == 0 else contextlib.nullcontext():
                fn(stacked, optimizer, active, *args)
            if k == 0:
                self.grads = {ref_name(n): torch.stack([leaves[n].grad.detach().clone() for leaves in stacked.leaves])
                              for n in stacked.leaves[0]}
            if k == CHECKED_STEPS - 1:
                self.end = _copies({**stacked.params, **stacked.buffers})
            if (k + 1) % steps == 0:
                self.snapshots.append(_copies({**stacked.params, **stacked.buffers}))
            if k % steps == 0:
                self.val_rows += len(active) * self.n_val
            self.beats += len(active) * min(self.batch, self.n_train - (k % steps) * self.batch)
            self.seed_steps += len(active)
            self.count += 1

        return recorded

    @contextlib.contextmanager
    def last_lstm(self, template):
        """Inside the block, each call of the classifier's last LSTM
        (``template``'s) keeps its outputs in ``lstm3`` and, in the
        backward, the gradient that flows into them in ``upstream``."""
        from ae_waveforms_tpu_torch.models import lstm_classifier as lc

        fn, target = lc.lstm_forward, getattr(template, LAST_LSTM)

        def recorded(lstm, x):
            out = fn(lstm, x)
            if lstm is target:
                self.lstm3.append(out[0].detach())
                out[0].register_hook(lambda g: self.upstream.append(g.detach().clone()))
            return out

        lc.lstm_forward = recorded
        try:
            yield
        finally:
            lc.lstm_forward = fn

    def batch_bce(self, fn):
        def recorded(*args):
            loss = fn(*args)
            self.losses.append(loss.detach())
            return loss

        return recorded

    def _roc_auc_device(self, fn):
        def recorded(*args):
            auc = fn(*args)
            self.val_aucs.append(auc.detach())
            return auc

        return recorded

    def predict(self, fn):
        def recorded(models, X, device=None):
            self.preds = fn(models, X, device=device)
            return self.preds

        return recorded


@contextlib.contextmanager
def installed(rec: Recorder):
    """``rec``'s wrappers in place of the module's functions inside the block."""
    from ae_waveforms_tpu_torch.classify import dl

    saved = {name: getattr(dl, name) for name in WRAPPED}
    for name, fn in saved.items():
        setattr(dl, name, getattr(rec, name)(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dl, name, fn)


@dataclass
class State:
    control: np.ndarray
    sick: np.ndarray
    params: Dict[str, torch.Tensor]  # every seed's initial weights, (S, ...) on the device, the reference's names
    bn: Dict[str, torch.Tensor]  # and BatchNorm state
    epochs: int = 0
    summary: Any = None
    recorder: Optional[Recorder] = None

    def init(self, s: int):
        """Seed s's weights and state as the program takes them: JAX-named
        numpy trees."""
        tree: Dict[str, Any] = {}
        for k, v in self.params.items():
            layer, _, leaf = k.partition(".")
            value = v[s].cpu().numpy()
            if leaf:
                tree.setdefault(layer, {})[leaf] = value
            else:
                tree[k] = value
        return tree, {k: v[s].cpu().numpy() for k, v in self.bn.items()}


def beats(bench):
    """Control and sick beats (n, 320) float32 a class: the sick class's T
    wave lowered by ``t_drop``."""
    n = bench.cell.config["beats_per_class"]
    dev = bench.device
    w = data.beats(2 * n, data.generator(dev, bench.seed, 1), dev)
    t = torch.arange(data.T_BEAT, device=dev, dtype=torch.float32)
    w[n:] -= bench.cell.traffic["t_drop"] * torch.exp(-0.5 * ((t - T_CENTRE) / T_WIDTH) ** 2)
    w = w.cpu().numpy()
    return w[:n], w[n:]


def initial(bench):
    """Every seed's initial weights from the seed, torch's uniform bounds,
    (S, ...) a leaf; BatchNorm gamma 1, beta 0, mean 0, variance 1."""
    c, t = bench.cell.config, bench.cell.traffic
    S, dev = t["seeds"], bench.device
    h1, h2, h3 = c["hidden_sizes"]
    f = c["fc_sizes"][1]
    shapes = {}
    for name, (i, h) in zip(ref.LSTMS, ((1, h1), (h1, h2), (h2, h3))):
        k = 1.0 / math.sqrt(h)
        shapes[name] = {"w_ih": ((S, 4 * h, i), k), "w_hh": ((S, 4 * h, h), k), "b_ih": ((S, 4 * h), k),
                        "b_hh": ((S, 4 * h), k)}
    for name, (i, o) in (("attn", (h3, 1)), ("fc1", (h3, f)), ("fc2", (f, 1))):
        k = 1.0 / math.sqrt(i)
        shapes[name] = {"w": ((S, o, i), k), "b": ((S, o), k)}
    params = ref.flatten(data.uniform_tree(shapes, data.generator(dev, bench.seed, 2), dev))
    params.update(bn_gamma=torch.ones((S, h3), device=dev), bn_beta=torch.zeros((S, h3), device=dev))
    return params, {"bn_mean": torch.zeros((S, h3), device=dev), "bn_var": torch.ones((S, h3), device=dev)}


def _sweep(state: State, bench, epochs: int, seeds: int):
    from ae_waveforms_tpu_torch.classify import dl

    c, t = bench.cell.config, bench.cell.traffic
    return dl.dl_size_seed_sweep(state.control, state.sick, sizes=(t["size"],), n_seeds=seeds,
                                 num_epochs=epochs, test_size=c["test_per_class"], vectorized=True,
                                 seed_chunk=t["seed_chunk"], remat_chunk=t["remat_chunk"], device=bench.device,
                                 init=state.init, dropout_rate=c["dropout"])


def check_schedule(config) -> None:
    """Raises where the program's learning-rate schedule is not the
    configuration's: lr, halved by ``lr_gamma`` at each milestone."""
    from ae_waveforms_tpu_torch.classify import dl

    epochs = [0, *[m + d for m in config["lr_milestones"] for d in (-1, 0)]]
    want = [config["lr"] * config["lr_gamma"] ** sum(e >= m for m in config["lr_milestones"]) for e in epochs]
    got = [dl._multistep_lr(e) for e in epochs]
    if not np.allclose(got, want, rtol=1e-12, atol=0.0):
        raise ValueError(f"the program's learning rates at epochs {epochs} are {got}, the configuration's {want}")


def setup(bench) -> State:
    c, t = bench.cell.config, bench.cell.traffic
    check_schedule(c)
    state = _state(bench)
    rec = Recorder(training(c))
    with installed(rec):
        _sweep(state, bench, 1, WARM_SEEDS)
    state.epochs = t["epochs"]
    cap = ""
    if bench.device.type == "cuda":
        from ae_waveforms_tpu_torch.classify import dl
        from ae_waveforms_tpu_torch.core.hbm import seed_axis_cap

        cap = seed_axis_cap(rec.n_train, rec.n_val, data.T_BEAT, c["batch_size"], dl.HIDDEN_SIZES, dl._param_count())
        cap = f"; core/hbm.py's seed cap at these shapes {cap}"
    print(f"portbench: warm-up of {WARM_SEEDS} seed, one epoch of {rec.count} stacked steps{cap}", file=sys.stderr)
    bench.tracer.warm()
    return state


def _state(bench) -> State:
    control, sick = beats(bench)
    params, bn = initial(bench)
    return State(control=control, sick=sick, params=params, bn=bn)


def measure(state: State, bench) -> Measured:
    c, t = bench.cell.config, bench.cell.traffic
    rec = Recorder(training(c), tracer=bench.tracer if bench.trace else None, trace_steps=tuple(t["trace_steps"]))
    state.recorder = rec
    try:
        with installed(rec):
            t0 = time.perf_counter()
            state.summary = _sweep(state, bench, state.epochs, t["seeds"])
            bench.synchronize()
            t1 = time.perf_counter()
    finally:
        bench.tracer.stop()
    wall = t1 - t0
    print(f"portbench: the window's call: {state.epochs} epochs of {rec.count // state.epochs} stacked steps in "
          f"{wall:.3f} s", file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(rec.losses))).sum()) if rec.losses else 0
    f = counts.fwd_per_beat(c)
    flops = 3 * f * rec.beats + f * (rec.val_rows + 2 * c["test_per_class"] * t["seeds"])
    first, last = t["trace_steps"]
    traced = max(0, min(last, rec.count) - first) if bench.trace else 0
    return Measured(attempted=rec.seed_steps, failed=failed, end_to_end={"train_beats_per_s": rec.beats / wall},
                    records={"model_flops": flops, "wall_s": wall, "epochs": state.epochs, "steps": rec.count,
                             "traced_steps": traced})


def batch_rows(n: int, batch: int, seed: int, steps: int):
    """The first ``steps`` batches of the first epoch of a seed with ``n``
    training rows: (rows (steps, B), kept (steps, B)), the permutation
    padded with row 0."""
    total = -(-n // batch) * batch
    rows = np.zeros(total, np.int64)
    rows[:n] = np.random.default_rng(seed).permutation(n)
    kept = np.arange(total) < n
    return rows.reshape(-1, batch)[:steps], kept.reshape(-1, batch)[:steps]


def reference_steps(bench, rec: Recorder, params, bn, dtype, tf32: bool = False, weights=None) -> Dict[str, Any]:
    """The reference's first ``CHECKED_STEPS`` steps of every seed on its
    rows as ``rec`` kept them, ``check_block`` seeds at a time:
    ``losses`` (steps, S), the first ``grads``, the parameters (``end``)
    and BatchNorm state (``bn``) after, and of the first step the last
    LSTM's outputs (``lstm3``, (S, B, T, H)), the LSTMs' gradients from
    the program's gradient at those outputs (``lstm_grads``) and the
    head's gradients from the program's last-LSTM outputs
    (``head_grads``); ``weights`` (B,) multiply every batch's row weights
    (a planted fault)."""
    c, t = bench.cell.config, bench.cell.traffic
    Xs, ys, _, _, seeds = rec.inputs
    B, dev = rec.batch, bench.device
    upstream, lstm3 = torch.stack(rec.upstream), torch.stack(rec.lstm3)
    parts = []
    for s0 in range(0, len(seeds), t["check_block"]):
        block = range(s0, min(s0 + t["check_block"], len(seeds)))
        orders = [batch_rows(ys.shape[1], B, seeds[s], CHECKED_STEPS) for s in block]
        gens = [torch.Generator(device=dev).manual_seed(seeds[s]) for s in block]
        batches, keeps = [], []
        for k in range(CHECKED_STEPS):
            x = np.stack([Xs[s][rows[k]] for s, (rows, _) in zip(block, orders)])
            y = np.stack([ys[s][rows[k]] for s, (rows, _) in zip(block, orders)]).astype(np.float32)
            w = torch.from_numpy(np.stack([kept[k] for _, kept in orders])).to(dev, torch.float32)
            batches.append((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                            w if weights is None else w * weights))
            per = [ref.keep_masks(g, ref.dropout_shapes(B, data.T_BEAT, c["hidden_sizes"][:2]), c["dropout"], dev)
                   for g in gens]
            keeps.append([torch.stack([p[j] for p in per]) for j in range(2)])
        sl = slice(block.start, block.stop)
        taps: Dict[str, Any] = {}
        losses, grads, end, end_bn = ref.train_steps({k: v[sl] for k, v in params.items()},
                                                     {k: v[sl] for k, v in bn.items()}, batches, keeps, c["dropout"],
                                                     c["lr"], dtype, tf32, taps, upstream[sl], lstm3[sl])
        parts.append(dict(losses=losses, grads=grads, end=end, bn=end_bn, **taps))
    cat = lambda key: {k: torch.cat([p[key][k] for p in parts]) for k in parts[0][key]}  # noqa: E731
    out = {key: cat(key) for key in ("grads", "end", "bn", "lstm_grads", "head_grads")}
    out.update(losses=np.concatenate([p["losses"] for p in parts], axis=1),
               lstm3=torch.cat([p["lstm3"] for p in parts]))
    return out


def program_steps(rec: Recorder) -> Dict[str, Any]:
    """The program's first steps in ``reference_steps``' form."""
    S = len(rec.inputs[4])
    losses = torch.stack(rec.losses[:CHECKED_STEPS * S]).double().cpu().numpy().reshape(CHECKED_STEPS, S)
    grads = rec.grads
    return dict(losses=losses, grads=grads, end={k: v for k, v in rec.end.items() if k in grads},
                bn={k: v for k, v in rec.end.items() if k not in grads}, lstm3=torch.stack(rec.lstm3),
                lstm_grads={k: v for k, v in grads.items() if k.split(".")[0] in ref.LSTMS},
                head_grads={k: grads[k] for k in ref.HEAD})


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The worst over the seeds and leaves of ||got - want|| over the
    larger of ||want|| and the seed's median leaf's."""
    norm = lambda t: torch.linalg.vector_norm(t.double().flatten(1), dim=1)  # noqa: E731
    sizes = torch.stack([norm(want[k]) for k in want])  # (leaves, S)
    floor = sizes.median(dim=0).values
    diffs = torch.stack([norm(got[k].to(want[k].device) - want[k]) for k in want])
    return float((diffs / torch.maximum(sizes, floor)).max())


def step_readings(got: Dict[str, Any], want: Dict[str, Any], start, start_bn) -> Dict[str, float]:
    """The first steps' numbers, each the worst over the seeds: the losses',
    first gradients' and changes' gaps of ``train.gaps`` (a seed's
    leaves); the BatchNorm state's, ||got - want|| over want's change
    from the start, of the mean and of the variance; and the first step's
    parts: ``lstm_gap``, ``lstm_grad_gap``, ``head_grad_gap``."""
    S = got["losses"].shape[1]
    seed = lambda tree, s: {k: v[s] for k, v in tree.items()}  # noqa: E731
    per = [gaps(list(got["losses"][:, s]), seed(got["grads"], s), seed(got["end"], s), seed(start, s),
                list(want["losses"][:, s]), seed(want["grads"], s), seed(want["end"], s), seed(start, s))
           for s in range(S)]
    out = {k: max(p[k] for p in per) for k in ("loss_gap", "grad_gap", "grad_med", "change_gap")}
    norm = lambda x: float(torch.linalg.vector_norm(x.double()))  # noqa: E731
    out["bn_gap"] = max(norm(got["bn"][k][s] - want["bn"][k][s]) / norm(want["bn"][k][s] - start_bn[k][s])
                        for k in want["bn"] for s in range(S))
    out["lstm_gap"] = lstm_gap(got["lstm3"], want["lstm3"])
    out["lstm_grad_gap"] = leaf_gap(got["lstm_grads"], want["lstm_grads"])
    out["head_grad_gap"] = leaf_gap(got["head_grads"], want["head_grads"])
    return out


def lstm_gap(outputs: torch.Tensor, ref_outputs: torch.Tensor) -> float:
    """The worst over the seeds of ||program - reference|| / ||reference||
    of the first step's last-LSTM outputs (S, B, T, H)."""
    diff = torch.linalg.vector_norm((outputs.double() - ref_outputs.double()).flatten(1), dim=1)
    return float((diff / torch.linalg.vector_norm(ref_outputs.double().flatten(1), dim=1)).max())


def selected(rec: Recorder) -> Tuple[np.ndarray, np.ndarray]:
    """The early-stopping rule replayed on the program's validation AUCs:
    (each seed's epoch whose snapshot the sweep keeps, the AUCs (epochs,
    S), NaN where a seed had stopped).  A seed keeps its last epoch whose
    AUC rose by more than ``min_delta`` over its best before, and where
    none did, its last.  None where the AUCs read do not fit the rule."""
    S, E = len(rec.inputs[4]), len(rec.snapshots)
    read = [float(a) for a in rec.val_aucs]
    patience, min_delta = rec.training["patience"], rec.training["min_delta"]
    table = np.full((E, S), np.nan)
    best, no_improve, pick = np.zeros(S), np.zeros(S, np.int64), np.full(S, E - 1)
    for e in range(E):
        active = np.flatnonzero(no_improve < patience)
        if len(read) < len(active):
            return None
        table[e, active], read = read[:len(active)], read[len(active):]
        improved = np.zeros(S, bool)
        improved[active] = table[e, active] - best[active] > min_delta
        pick[improved] = e
        best = np.where(improved, table[e], best)
        no_improve = np.where(no_improve >= patience, no_improve, np.where(improved, 0, no_improve + 1))
    return (pick, table) if not read else None


def picked(rec: Recorder, pick: np.ndarray) -> Dict[str, torch.Tensor]:
    """Each seed's parameters and state from its picked epoch's snapshot,
    (S, ...) a leaf."""
    return {k: torch.stack([rec.snapshots[e][k][s] for s, e in enumerate(pick)]) for k in rec.snapshots[0]}


def select_err(rec: Recorder, values: Dict[str, torch.Tensor]) -> float:
    """The seeds whose returned model differs, in any bit, from ``values``."""
    wrong = 0
    for s, (params, state) in enumerate(rec.models):
        got = {**ref.flatten(params), **state}
        wrong += any(k not in got or not np.array_equal(np.asarray(got[k]), v[s].cpu().numpy())
                     for k, v in values.items())
    return float(wrong)


def model_probs(bench, state: State, rec: Recorder, snap: Dict[str, torch.Tensor], dtype, tf32: bool = False,
                alter=None) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's eval-mode probabilities: of the returned models on
    the test rows (S, test rows), and of the picked snapshots ``snap`` on
    each seed's validation rows (S, validation rows)."""
    block = bench.cell.traffic["check_block"]
    x, _ = test_rows(bench, state)
    params, bn = stacked_models(rec.models, bench.device)
    test = ref.probabilities(params, bn, x, dtype, block=block, tf32=tf32, alter=alter)
    xv = torch.from_numpy(np.asarray(rec.inputs[2], np.float32)).to(bench.device)
    snap_params = {k: v for k, v in snap.items() if k not in state.bn}
    snap_bn = {k: v for k, v in snap.items() if k in state.bn}
    val = ref.probabilities(snap_params, snap_bn, xv, dtype, block=VAL_BLOCK, tf32=tf32, alter=alter)
    return test.cpu().numpy(), val.cpu().numpy()


def prob_readings(got: Tuple[np.ndarray, Optional[np.ndarray]], want: Tuple[np.ndarray, np.ndarray], y: np.ndarray,
                  yv: np.ndarray, test_aucs=None, val_aucs=None) -> Dict[str, float]:
    """``got`` and ``want``: (test probabilities (S, n), validation
    probabilities (S, m)).  The largest gap of a test probability, of a
    seed's test AUC (``test_aucs``, or those of got's) and of its
    validation AUC (``val_aucs``, or those of got's) against want's
    probabilities and their AUCs."""
    auc = lambda labels, probs: np.array([ref.roc_auc(v, p) for v, p in zip(labels, probs)])  # noqa: E731
    test_aucs = auc([y] * len(got[0]), got[0]) if test_aucs is None else np.asarray(test_aucs, np.float64)
    val_aucs = auc(yv, got[1]) if val_aucs is None else np.asarray(val_aucs, np.float64)
    return {"prob_gap": float(np.abs(np.asarray(got[0], np.float64) - want[0]).max()),
            "auc_err": float(np.abs(test_aucs - auc([y] * len(want[0]), want[0])).max()),
            "val_auc_err": float(np.abs(val_aucs - auc(yv, want[1])).max())}


def test_rows(bench, state: State):
    """The sweep's test rows on the device (n, T, 1) and their labels."""
    ts = bench.cell.config["test_per_class"]
    x = np.concatenate([state.control[-ts:], state.sick[-ts:]])[:, :, None]
    return torch.from_numpy(x).to(bench.device), np.r_[np.zeros(ts), np.ones(ts)]


def stacked_models(models, device):
    """The returned (params, state) trees as the reference's (S, ...)
    tensors."""
    params = {k: torch.from_numpy(np.stack([ref.flatten(p)[k] for p, _ in models])).to(device)
              for k in ref.flatten(models[0][0])}
    return params, {k: torch.from_numpy(np.stack([s[k] for _, s in models])).to(device) for k in models[0][1]}


@dataclass
class Evaluation:
    """The check's readings of a window and the float64 reference's
    results they were read against."""

    readings: Dict[str, float]
    steps: Dict[str, Any]
    snap: Dict[str, torch.Tensor]
    probs: Tuple[np.ndarray, np.ndarray]


def evaluate(state: State, bench) -> Optional[Evaluation]:
    """Every number of ``NUMBERS`` of the last window; None where the
    window did not run what the check reads."""
    rec = state.recorder
    if rec is None or rec.count < CHECKED_STEPS or rec.preds is None or rec.chunks != 1:
        return None
    t0 = time.perf_counter()
    if bench.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(bench.device)
    want = reference_steps(bench, rec, state.params, state.bn, torch.float64)
    readings = step_readings(program_steps(rec), want, state.params, state.bn)
    picks = selected(rec)
    if picks is None:
        readings.update(select_err=float("inf"), val_auc_err=float("inf"))
        snap = {}
        probs = (np.zeros(0), np.zeros(0))
    else:
        pick, table = picks
        snap = picked(rec, pick)
        readings["select_err"] = select_err(rec, snap)
        probs = model_probs(bench, state, rec, snap, torch.float64)
        _, y = test_rows(bench, state)
        readings.update(prob_readings((rec.preds, None), probs, y, rec.inputs[3], state.summary[0]["aucs"],
                                      table[pick, np.arange(len(pick))]))
    peak = torch.cuda.max_memory_allocated(bench.device) / 2**30 if bench.device.type == "cuda" else 0.0
    spread = np.std(rec.preds, axis=1)
    print(f"portbench: the check took {time.perf_counter() - t0:.1f} s, peak device memory {peak:.2f} GiB; the "
          f"test probabilities' spread a seed (std) {spread.min():.3e} to {spread.max():.3e}", file=sys.stderr)
    return Evaluation(readings=readings, steps=want, snap=snap, probs=probs)


def check(state: State, bench, measured: Measured) -> List[Comparison]:
    rec = state.recorder
    if rec is not None and rec.chunks != 1:
        return [Comparison("chunks", float(rec.chunks), 1.0)]
    ev = evaluate(state, bench)
    if ev is None:
        return [Comparison("steps_checked", float("inf"), 0.0)]
    return [Comparison(k, ev.readings.get(k, float("inf")), limit) for k, limit in bench.cell.traffic["limits"].items()]


def altered_row(pooled: torch.Tensor) -> torch.Tensor:
    """The planted fault: the first row's pooled features moved by
    ``ALTERED``."""
    pooled = pooled.clone()
    pooled[:, 0] += ALTERED
    return pooled


@contextlib.contextmanager
def tf32_backward():
    """The planted fault of ``control_readings``: ``classify.dl``'s
    backward outside ``cudnn_fp32``, with cuDNN's TF32 on."""
    from ae_waveforms_tpu_torch.classify import dl

    c = torch.backends.cudnn
    saved = dl.cudnn_fp32
    dl.cudnn_fp32 = lambda: c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                                    deterministic=c.deterministic, allow_tf32=True)
    try:
        yield
    finally:
        dl.cudnn_fp32 = saved


def control_readings(bench) -> Dict[str, Dict[str, float]]:
    """The numbers the check compares, each against the float64 reference
    of one window of the cell (set-up, window, check, as a run makes
    them): ``program``, the check's own readings; from the reference put
    in the program's place in the precision below the configuration's
    (``control``: float32 with TF32 on) and in float32 with TF32 off
    (``float32``: float32's own rounding, a reading and no fault), each
    with the program's gradient at the last LSTM's outputs and the
    program's last-LSTM outputs as its inputs to the LSTMs' backward and
    to the head, and on the window's returned models and picked
    snapshots; from the reference with half of each batch left out
    (``half_batch``) and from steps that leave the state as it was
    (``unchanged``); the probabilities of the float64 reference with the
    first row's pooled features moved by ``ALTERED`` (``altered``); and
    the window run again, its backward outside ``cudnn_fp32`` with cuDNN's
    TF32 on (``tf32_backward``), through the check."""
    B, dev = bench.cell.config["batch_size"], bench.device
    state = setup(bench)
    measured = measure(state, bench)
    ev = evaluate(state, bench)
    rec = state.recorder
    start, start_bn = state.params, state.bn
    out = {"program": ev.readings}
    half = torch.cat([torch.ones(B // 2), torch.zeros(B - B // 2)]).to(dev)
    runs = {"control": reference_steps(bench, rec, start, start_bn, torch.float32, tf32=True),
            "float32": reference_steps(bench, rec, start, start_bn, torch.float32),
            "half_batch": reference_steps(bench, rec, start, start_bn, torch.float64, weights=half),
            "unchanged": dict(ev.steps, end=start, bn=start_bn)}
    for name, got in runs.items():
        out[name] = step_readings(got, ev.steps, start, start_bn)
    _, y = test_rows(bench, state)
    yv = rec.inputs[3]
    for name, tf32 in (("control", True), ("float32", False)):
        probs = model_probs(bench, state, rec, ev.snap, torch.float32, tf32=tf32)
        out[name].update(prob_readings(probs, ev.probs, y, yv))
    altered = model_probs(bench, state, rec, ev.snap, torch.float64, alter=altered_row)
    out["altered"] = prob_readings(altered, ev.probs, y, yv)
    with tf32_backward():
        measured = measure(state, bench)
    out["tf32_backward"] = {c.name: c.value for c in check(state, bench, measured)}
    return out
