"""Driver ``gbt_search``: the window calls
``ae_waveforms_tpu_torch.classify.harness.grid_search_cv(X, y,
n_candidates, cv, random_state, vectorized=True)``, the GBT study's grid
search, back to back, and starts no call once ``--seconds`` have passed;
its work is every tree the candidates ask for (Σ n_estimators x folds a
call) over the calls' whole time.

X and y are the classifier cohorts, made from the seed on the card:
control and sick latents, the test rows held back as
``harness.prepare_class_data`` holds them, the first rows of each class's
training part searched.  ``random_state`` is the cell's, so every run does
the same work on other data.

Set-up warms the fit at each chunk's number of fits and depth for a few
trees.  A wrapper of the harness's ``fit_gbt_sweep_margins`` and
``_roc_auc_device`` (installed from here) keeps the first call's ensembles
and margins and every call's held-out AUCs for the check; in a traced run wrappers of the
fit's ``left_histograms_fixed`` and ``route_rows`` record each launch's
shapes and open a sub-window over trees ``trace_trees`` of each chunk of
the first call.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data
from portbench.bench import Comparison, Measured
from portbench.counts import gbt as gbt_counts
from portbench.reference import gbt as ref

HP_KEYS = ("learning_rate", "gamma", "min_child_weight", "subsample", "colsample_bytree", "n_estimators", "max_depth")
# every number the check can compare; a cell's traffic file gives the limit of each it compares
NUMBERS = ("split_diff", "leaf_err", "margin_err", "auc_err")


@dataclass
class State:
    X: np.ndarray
    y: np.ndarray
    fits: List[Any] = field(default_factory=list)  # the first call's (ensemble, margins) a chunk
    aucs: List[torch.Tensor] = field(default_factory=list)  # every call's (S,) AUCs a chunk
    calls: int = 0


def _cohorts(bench):
    t = bench.cell.traffic
    control, sick = data.cohorts(t["rows_per_class"], t["latents"], t["shift"], t["shifted"],
                                 data.generator(bench.device, bench.seed, 3), bench.device)
    n, test = t["searched_per_class"], t["test_per_class"]
    control, sick = control[:-test][:n], sick[:-test][:n]
    X = np.concatenate([control, sick]).astype(np.float32)
    y = np.concatenate([np.zeros(len(control)), np.ones(len(sick))]).astype(np.float32)
    return X, y


def setup(bench) -> State:
    from ae_waveforms_tpu_torch.classify.gbt import bin_data, compute_bin_edges, fit_gbt_sweep_margins

    c, t = bench.cell.config, bench.cell.traffic
    dev = bench.device
    X, y = _cohorts(bench)
    params = ref.lhs_params(c["gs_candidates"], c["gs_random_state"])
    bins = bin_data(torch.as_tensor(X, device=dev), torch.as_tensor(compute_bin_edges(X), device=dev))
    y_dev = torch.as_tensor(y, device=dev)
    for depth, _, chunk in ref.chunks(params, c["gs_folds"])[:: c["gs_folds"]]:
        S = len(chunk)
        hp = torch.tensor([[params[i][k] for i in chunk] for k in HP_KEYS], dtype=torch.float32, device=dev)
        fit_gbt_sweep_margins(bins, y_dev, torch.ones((S, len(y)), device=dev), c["gs_random_state"], hp[0], hp[1],
                              hp[2], hp[3], hp[4], hp[5], max_depth=depth, n_estimators=t["warm_trees"],
                              depth_limits=hp[6])
    bench.synchronize()
    bench.tracer.warm()
    return State(X=X, y=y)


class _Tracing:
    """Opens a sub-window over trees [t0, t1) of each chunk of the first
    call, counting the fit's histogram calls (one a level), and records the
    shapes of the K1 and K2 launches inside it."""

    def __init__(self, bench, trees):
        self.tracer = bench.tracer
        self.t0, self.t1 = trees
        self.depth = 1
        self.levels = 0
        self.on = False
        self.hist: List[Any] = []
        self.route: List[Any] = []
        self.trees = 0

    def chunk(self, depth: int) -> None:
        self.tracer.stop()
        self.depth, self.levels = depth, 0

    def hist_call(self, binsT, g, h, node_of, half: int, n_bins: int) -> None:
        if self.on:
            tree, level = divmod(self.levels, self.depth)
            if level == 0 and tree == self.t0:
                self.tracer.start()
            elif level == 0 and tree == self.t1:
                self.tracer.stop()
                self.trees += self.t1 - self.t0
            if self.tracer.active:
                self.hist.append((binsT.shape, half, n_bins, g, h, node_of))
        self.levels += 1

    def route_call(self, binsT, bf) -> None:
        if self.on and self.tracer.active:
            self.route.append((binsT.shape, bf.shape))


def measure(state: State, bench) -> Measured:
    from ae_waveforms_tpu_torch.classify import gbt, harness

    c, t = bench.cell.config, bench.cell.traffic
    tracing = _Tracing(bench, t["trace_trees"]) if bench.trace else None
    fit, auc, hist, route = harness.fit_gbt_sweep_margins, harness._roc_auc_device, gbt.left_histograms_fixed, gbt.route_rows

    def fit_recorded(*args, **kwargs):
        if tracing is not None:
            tracing.chunk(kwargs["max_depth"])
        out = fit(*args, **kwargs)
        if state.calls == 0:
            state.fits.append(out)
        if tracing is not None:
            tracing.tracer.stop()
        return out

    def auc_recorded(*args):
        out = auc(*args)
        state.aucs.append(out)
        return out

    def hist_recorded(binsT, g, h, node_of, shift, *, half, n_bins, packed=None):
        tracing.hist_call(binsT, g, h, node_of, half, n_bins)
        return hist(binsT, g, h, node_of, shift, half=half, n_bins=n_bins, packed=packed)

    def route_recorded(binsT, node_of, bf, bb, do_split):
        tracing.route_call(binsT, bf)
        return route(binsT, node_of, bf, bb, do_split)

    harness.fit_gbt_sweep_margins, harness._roc_auc_device = fit_recorded, auc_recorded
    if tracing is not None:
        gbt.left_histograms_fixed, gbt.route_rows = hist_recorded, route_recorded
    try:
        t0 = time.perf_counter()
        while True:
            if tracing is not None:
                tracing.on = state.calls == 0
            t_call = time.perf_counter()
            harness.grid_search_cv(state.X, state.y, n_candidates=c["gs_candidates"], cv=c["gs_folds"],
                                   random_state=c["gs_random_state"], vectorized=True, device=bench.device)
            state.calls += 1
            print(f"portbench: grid search call {state.calls}: {time.perf_counter() - t_call:.3f} s", file=sys.stderr)
            if time.perf_counter() - t0 >= bench.seconds:
                break
        bench.synchronize()
        wall = time.perf_counter() - t0
    finally:
        harness.fit_gbt_sweep_margins, harness._roc_auc_device = fit, auc
        gbt.left_histograms_fixed, gbt.route_rows = hist, route
        bench.tracer.stop()
    params = ref.lhs_params(c["gs_candidates"], c["gs_random_state"])
    n = len(state.y)
    fold_rows = [n - len(f) for f in ref.folds(n, c["gs_folds"], c["gs_random_state"])]
    aucs = torch.cat([a.reshape(-1) for a in state.aucs])
    records = {"wall_s": wall,
               "ops": state.calls * gbt_counts.grid_search_ops(params, fold_rows, n, state.X.shape[1], c["gbt_bins"])}
    if tracing is not None:
        records.update(profiled_trees=tracing.trees, k1_launches=_k1_launches(tracing.hist), k2_launches=[
            dict(S=bf[0], n=binsT[1], F=binsT[0], width=bf[1], levels=1, node_in=True) for binsT, bf in tracing.route])
    trees = state.calls * gbt_counts.grid_search_trees(params, c["gs_folds"])
    return Measured(attempted=state.calls * len(params) * c["gs_folds"], failed=int((~torch.isfinite(aucs)).sum()),
                    end_to_end={"gbt_trees_per_s": trees / wall}, records=records)


def _k1_launches(hist) -> List[Dict[str, int]]:
    """Each traced K1 launch's shapes and the rows that add in it (a left
    child of the level, g or h not zero), counted after the window."""
    out = []
    for (F, n), half, n_bins, g, h, node in hist:
        matched = int(((node % 2 == 0) & (node < 2 * half) & ((g != 0) | (h != 0))).sum())
        out.append(dict(S=g.shape[0], n=n, F=F, n_bins=n_bins, half=half, matched=matched))
    return out


def reference_fits(bench, X: np.ndarray, y: np.ndarray, sample: Dict[int, List[int]], dtype=torch.float64):
    """The reference's fits of the sampled positions of each chunk of one
    grid-search call: {chunk: (heaps, margins, held-out AUCs)}, one batched
    reference fit per heap depth."""
    c = bench.cell.config
    dev = bench.device
    params = ref.lhs_params(c["gs_candidates"], c["gs_random_state"])
    n = len(y)
    folds = ref.folds(n, c["gs_folds"], c["gs_random_state"])
    plan = ref.chunks(params, c["gs_folds"])
    cap = max(int(p["n_estimators"]) for p in params)
    bins_of, weight_of = {}, {}
    for f, held in enumerate(folds):
        w = np.ones(n, np.float32)
        w[held] = 0.0
        bins_of[f] = torch.as_tensor(ref.quantile_bins(X[w > 0], X, c["gbt_bins"]), device=dev)
        weight_of[f] = torch.as_tensor(w, device=dev)
    y_dev = torch.as_tensor(y, device=dev)
    out = {}
    for depth in sorted({d for d, _, _ in plan}):
        rows = [(k, j) for k, (d, _, _) in enumerate(plan) if d == depth for j in sample[k]]
        if not rows:
            continue
        fold = [plan[k][1] for k, _ in rows]
        cand = [plan[k][2][j] for k, j in rows]
        hp = {key: torch.tensor([params[c][key] for c in cand], dtype=torch.float32, device=dev) for key in HP_KEYS}
        heaps, margin = ref.fit(torch.stack([bins_of[f] for f in fold]), y_dev,
                                torch.stack([weight_of[f] for f in fold]), c["gs_random_state"], hp, depth, cap,
                                c["gbt_bins"], dtype)
        for i, (k, j) in enumerate(rows):
            held = torch.as_tensor(folds[plan[k][1]], device=dev)
            auc = ref.roc_auc(margin[i:i + 1, held], y_dev[held])[0]
            out.setdefault(k, []).append((j, {key: v[i] for key, v in heaps.items()}, margin[i], auc))
    return out


def sample_positions(bench, sizes: List[int]) -> Dict[int, List[int]]:
    """The fits checked: ``fits_checked`` positions of each chunk, drawn from
    the seed (every position where a chunk holds no more)."""
    rng = np.random.default_rng(bench.seed)
    k = bench.cell.traffic["fits_checked"]
    return {c: sorted(rng.choice(s, size=min(k, s), replace=False).tolist()) for c, s in enumerate(sizes)}


def gaps(program, reference) -> Dict[str, float]:
    """Split slots (flag, and feature and bin where split) that differ;
    the largest gaps of a leaf, a pool row's margin and a held-out AUC (of
    every call: ``program[k]`` holds each call's AUCs of chunk k)."""
    split_diff, leaf, margin, auc = 0, 0.0, 0.0, 0.0
    for k, fits in reference.items():
        ens, margins, calls = program[k]
        for j, heaps, m_ref, a_ref in fits:
            s_p, s_r = ens.is_split[j], heaps["is_split"]
            differ = (s_p != s_r) | (s_r & ((ens.feat[j] != heaps["feat"]) | (ens.thresh[j] != heaps["thresh"])))
            split_diff += int(differ.sum())
            leaf = max(leaf, float((ens.leaf[j] - heaps["leaf"]).abs().max()))
            margin = max(margin, float((margins[j] - m_ref).abs().max()))
            auc = max([auc] + [abs(float(aucs[j]) - float(a_ref)) for aucs in calls])
    return {"split_diff": float(split_diff), "leaf_err": leaf, "margin_err": margin, "auc_err": auc}


def check(state: State, bench, measured: Measured) -> List[Comparison]:
    c, t = bench.cell.config, bench.cell.traffic
    chunks = len(ref.chunks(ref.lhs_params(c["gs_candidates"], c["gs_random_state"]), c["gs_folds"]))
    if len(state.fits) != chunks:
        return [Comparison("chunks_checked", float(abs(len(state.fits) - chunks)), 0.0)]
    if len(state.aucs) != state.calls * chunks:
        return [Comparison("aucs_checked", float(abs(len(state.aucs) - state.calls * chunks)), 0.0)]
    program = {k: (ens, margins, state.aucs[k::chunks]) for k, (ens, margins) in enumerate(state.fits)}
    sample = sample_positions(bench, [ens.feat.shape[0] for ens, _ in state.fits])
    reference = reference_fits(bench, state.X, state.y, sample)
    readings = gaps(program, reference)
    return [Comparison(k, readings[k], limit) for k, limit in t["limits"].items()]


def control_readings(bench) -> Dict[str, Dict[str, float]]:
    """The numbers the check compares, read from the reference put in the
    program's place with its float64 arithmetic (sigmoid, gains, leaves) in
    float32, against the float64 reference, over the fits a run checks."""
    from types import SimpleNamespace

    c = bench.cell.config
    X, y = _cohorts(bench)
    plan = ref.chunks(ref.lhs_params(c["gs_candidates"], c["gs_random_state"]), c["gs_folds"])
    sample = sample_positions(bench, [len(cand) for _, _, cand in plan])
    reference = reference_fits(bench, X, y, sample)
    control = reference_fits(bench, X, y, sample, torch.float32)
    program = {}
    for k, fits in control.items():
        S = len(plan[k][2])
        heaps = {key: [None] * S for key in ("feat", "thresh", "is_split", "leaf")}
        margins, aucs = [None] * S, [float("nan")] * S
        for j, h, m, a in fits:
            for key in heaps:
                heaps[key][j] = h[key]
            margins[j], aucs[j] = m, a
        program[k] = (SimpleNamespace(**heaps), margins, [aucs])
    return {"control": gaps(program, reference)}
