"""Smoke run of the PyTorch/CUDA port (``ae_waveforms_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device and build: the card's name and power limit; the three CUDA
   kernels built from ``ae_waveforms_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. the fused LSTM encoder kernel (8-block clusters) against its plain
   version at the serving shape (B=64, T=320, 1->128->64->10), at latent 2
   and 20, at B=1 and at B=256 (the 200-beat request's bucket), within
   2e-5; at B=64 and 256 its launch plan and cudaOccupancyMaxActiveClusters,
   and its time beside the plain version and a ``torch.nn.LSTM`` stack
   computing the same latent (device time per call from a CUDA graph of
   many calls, and per phase of its time loop; time per call with launch
   gaps from CUDA events).
3. the GBT routing kernel against its plain version, exactly, at the
   serving head's shapes (100 trees, 64 and 256 rows, 1..32 nodes), one
   1024-node level and the fit-time shape (96 fits, 12,500 rows).
4. the serving path through its entry points: a run directory written with
   the port's ``save_state``, ``Scorer.from_run`` -> ``warmup`` ->
   ``score`` for 1, 37, 64 and 200 beats, then again with a 100-tree
   depth-6 GBT head attached through the bridge.  Both kernels' launch
   counts must rise during the run, and every output must match the same
   ``Scorer`` on the CPU (latents 2e-5, reconstruction 1e-4, probability
   1e-5).  Prints p50 latency and beats/s per request size, and where the
   device time of a 64-beat score goes, by kernel, with the idle share.
5. the GBT histogram kernel at the fit's shapes (96 fits x 12,000 rows at
   1..16 left children, and at 16 with g = h = 0 on 46% of rows as in a
   fit; 24 fits at 32..256; 25 fits x 12,500 rows at 16; the smoke grid's 6
   fits at 1, 16 and 256, fit-like): its fixed-point sums equal to its plain
   version's and bit-identical across two calls; scaled to float32, within
   1e-4 absolute and 1e-5 relative of the float64 plain version.  Prints
   ``hist_plan``'s launch and ``cudaOccupancyMaxActiveClusters`` for it, and
   times the kernel beside the plain version and a float32 ``torch.einsum``
   one-hot contraction.
6. the classify path through its entry point: a synthetic latent data dir
   (6,500 control and 6,500 sick rows of 10 latents) and
   ``cli.classify ppv --vectorized --gs_candidates 12 --seeds 25``, the
   harness at full width.  The histogram and routing kernels' launch
   counts must rise.  Prints the grid search's and PPV sweep's wall
   seconds, fold-fits per second, ms per tree per fit and the median AUC
   and PPV.
7. determinism: a 4-fit sweep on 2,000 rows, fitted twice on the card
   (bit-identical ensembles and margins) and once on the CPU (the same
   trees, margins within 5e-3).

Prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.  Weights, beats and latents are random, made from
seeds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s and the
# float32 rate outside the tensor cores; both kernels work in float32/int32
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

T_BEAT = 320
LATENT_ATOL = 2e-5  # kernel against plain version, GPU Scorer against CPU Scorer
SIZES = (1, 37, 64, 200)
RUN = "smoke-run"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def graph_ms(torch, fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed and timed with CUDA events, so the host's launch
    gaps between the calls are not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return event_ms(torch, graph.replay, 3) / reps


def event_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around ``reps``
    back-to-back calls after a warm one; includes the gaps in which the card
    waits for the host to launch the next kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_beats(rng, n: int) -> np.ndarray:
    """ECG-like median beats (P, Q, R, S, T bumps, R at a third of the
    beat, as the extractor cuts them) with seeded jitter, amplitude, baseline
    offset and noise."""
    t = np.arange(T_BEAT, dtype=np.float64)
    g = lambda c, w: np.exp(-0.5 * ((t[None, :] - c) / w) ** 2)  # noqa: E731
    a = rng.uniform(0.7, 1.3, size=(n, 5))
    j = rng.normal(0.0, 4.0, size=(n, 2))
    waves = (0.15 * a[:, :1] * g(60 + j[:, :1], 10) - 0.1 * a[:, 1:2] * g(98, 3)
             + a[:, 2:3] * g(106, 4) - 0.2 * a[:, 3:4] * g(114, 3)
             + 0.3 * a[:, 4:5] * g(210 + j[:, 1:], 20))
    waves = waves * rng.uniform(0.3, 3.0, size=(n, 1)) + rng.normal(0.0, 0.5, size=(n, 1))
    return (waves + 0.02 * rng.standard_normal((n, T_BEAT))).astype(np.float32)


def separated_edges(z: np.ndarray, n_bins: int, margin: float) -> np.ndarray:
    """Bin edges for latents ``z`` (n, F), none within ``margin`` of a value
    of ``z``: each edge is the midpoint of a gap between sorted neighbours
    wider than 2 * margin (or lies outside the values), the one nearest its
    quantile.  A latent that another device computes within ``margin`` of
    this one then falls in the same bin; edges may repeat."""
    edges = np.empty((z.shape[1], n_bins - 1), np.float32)
    for f in range(z.shape[1]):
        s = np.sort(z[:, f]).astype(np.float64)
        wide = s[1:] - s[:-1] > 2 * margin
        cand = np.concatenate([[s[0] - 1.0], 0.5 * (s[1:] + s[:-1])[wide], [s[-1] + 1.0]])
        targets = np.quantile(s, np.linspace(0, 1, n_bins + 1)[1:-1])
        edges[f] = cand[np.abs(cand[None, :] - targets[:, None]).argmin(axis=1)]
    return edges


def phase_encoder(torch, dev):
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.ops.lstm_encoder import (
        CLUSTER, encode_fused, encode_fused_reference, encoder_plan, max_active_clusters,
    )

    beats = {64: synthetic_beats(np.random.default_rng(1), 64),
             256: synthetic_beats(np.random.default_rng(9), 256)}
    H1, H2 = 128, 64
    phases = T_BEAT + 2  # the kernel's skewed time loop: one cluster barrier per phase
    result = {}
    for B, latent in ((64, 10), (64, 2), (64, 20), (1, 10), (256, 10)):
        model = LSTMAutoencoder(latent, generator=torch.Generator().manual_seed(100 + latent), device=dev)
        x = torch.from_numpy(beats[64 if B <= 64 else 256][:B, :, None].copy()).to(dev)
        params = model.jax_tree()
        with torch.no_grad():
            got = encode_fused(params, x)
            ref = encode_fused_reference(params, x)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        print(f"[lstm_encoder] B={B} T={T_BEAT} 1->128->64->{latent}: max_abs_err={err:.3e} (tolerance 2e-5)")
        check(err <= LATENT_ATOL and bool(torch.isfinite(got).all()), f"lstm_encoder disagrees at B={B} L={latent}: {err}")
        if latent != 10 or B == 1:
            continue

        plan = encoder_plan(B, H1, H2, latent, T_BEAT)
        active = max_active_clusters(plan, H1, H2, latent, T_BEAT)
        print(f"[lstm_encoder] plan at B={B}: {plan.rows_per_cluster} rows per cluster of {CLUSTER} blocks, "
              f"{plan.clusters} clusters, {plan.smem_bytes} bytes of shared memory per block; "
              f"cudaOccupancyMaxActiveClusters {active} ({'one wave' if plan.clusters <= active else 'two or more waves'})")

        def library():
            h = x
            for layer in (model.enc1, model.enc2, model.enc3):
                h, (h_last, _) = layer(h)
            return h_last[0]

        with torch.no_grad():
            lib_err = (library() - ref).abs().max().item()
            ms = graph_ms(torch, lambda: encode_fused(params, x), 20)
            plain_ms = graph_ms(torch, lambda: encode_fused_reference(params, x), 3)
            # cuDNN's RNN is not captured in a graph; its three launches take
            # over a millisecond, so the host's launch gaps add little
            library_ms = event_ms(torch, library, 20)
            call_ms = event_ms(torch, lambda: encode_fused(params, x), 20)
        flops = 2 * B * T_BEAT * (4 * H1 * (1 + H1) + 4 * H2 * (H1 + H2) + 4 * latent * (H2 + latent))
        n_params = sum(p.numel() for name in ("enc1", "enc2", "enc3") for p in params[name].values())
        bound_ms, bound_by = bound(4 * (B * T_BEAT + n_params + B * latent), flops)
        us_per_phase = ms * 1e3 / phases
        print(f"[lstm_encoder] B={B}, device ms per call (CUDA graph): kernel {ms:.4f} ({us_per_phase:.3f} us "
              f"per phase of {phases}), plain {plain_ms:.4f}; per call with launch gaps (CUDA events): kernel "
              f"{call_ms:.4f}, torch.nn.LSTM x3 {library_ms:.4f} (its max_abs_err {lib_err:.3e}); "
              f"bound {bound_ms:.4f} ms by {bound_by}")
        timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                      rows_per_cluster=plan.rows_per_cluster, phases=phases, us_per_phase=us_per_phase)
        if B == 64:  # the serving bucket: the kernels line's numbers
            result = dict(max_abs_err=err, cluster=CLUSTER, **timing)
        else:
            result["at_B256"] = dict(max_abs_err=err, **timing)
    return result


def route_inputs(torch, dev, rng, S, n, n_nodes, F=10, n_bins=64):
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(rng.integers(0, n_bins, size=(F, n)).astype(np.int32)),
            t(rng.integers(0, n_nodes, size=(S, n)).astype(np.int32)),
            t(rng.integers(0, F, size=(S, n_nodes)).astype(np.int32)),
            t(rng.integers(0, n_bins, size=(S, n_nodes)).astype(np.int32)),
            t(rng.random((S, n_nodes)) < 0.7))


def phase_route(torch, dev):
    from ae_waveforms_tpu_torch.ops.gbt_route import route_rows, route_rows_reference

    rng = np.random.default_rng(2)
    shapes = [(100, n, 2**d) for n in (64, 256) for d in range(6)] + [(100, 256, 1024), (96, 12500, 32)]
    result = {}
    for S, n, n_nodes in shapes:
        args = route_inputs(torch, dev, rng, S, n, n_nodes)
        got = route_rows(*args)
        ref = route_rows_reference(*args)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum().item())
        check(mismatches == 0, f"gbt_route differs at S={S} n={n} n_nodes={n_nodes}: {mismatches} rows")
        ms = graph_ms(torch, lambda: route_rows(*args), 50)
        plain_ms = graph_ms(torch, lambda: route_rows_reference(*args), 20)
        call_ms = event_ms(torch, lambda: route_rows(*args), 50)
        F = args[0].shape[0]
        bound_ms, bound_by = bound(4 * F * n + 2 * 4 * S * n + S * n_nodes * 9, 3 * S * n)
        print(f"[gbt_route] S={S} n={n} n_nodes={n_nodes}: exact; device ms per call (CUDA graph): "
              f"kernel {ms:.5f}, plain {plain_ms:.5f}; kernel per call with launch gaps {call_ms:.5f}; "
              f"bound {bound_ms:.6f} ms by {bound_by}")
        if (S, n, n_nodes) == (100, 64, 32):  # the serving head's deepest level
            result = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return result


def random_gbt_arrays(rng, n_trees=100, depth=6, F=10, n_bins=64):
    max_nodes = 2**depth
    is_split = rng.random((n_trees, max_nodes)) < 0.8
    is_split[:, -1] = False  # the heap's inert slot
    return dict(
        feat=rng.integers(0, F, size=(n_trees, max_nodes)).astype(np.int32),
        thresh=rng.integers(0, n_bins, size=(n_trees, max_nodes)).astype(np.int32),
        is_split=is_split,
        leaf=(0.1 * rng.standard_normal((n_trees, max_nodes))).astype(np.float32),
        lr=np.float32(0.3),
    )


def serve_breakdown(torch, scorer, waves, reps: int = 10) -> None:
    """Where a score's time goes on the card: device ms per call by kernel
    group (torch.profiler) and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    groups = {"lstm_encoder": ("lstm_encoder_kernel",), "gbt_route": ("gbt_route_kernel",),
              "decoder cuDNN LSTM": ("RNN", "rnn", "LSTM"), "copies": ("Memcpy", "Memset")}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            scorer.score(waves)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    counts = {e.key: e.count for e in prof.key_averages()}
    seen = {g: sum(c for k, c in counts.items() if groups[g][0] in k) for g in ("lstm_encoder", "gbt_route")}
    if seen != {"lstm_encoder": reps, "gbt_route": 6 * reps}:
        print(f"[serve] breakdown not measured: torch.profiler recorded {seen} of "
              f"{{'lstm_encoder': {reps}, 'gbt_route': {6 * reps}}} launches")
        return
    per = dict.fromkeys([*groups, "other"], 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        per[name] += us / reps / 1e3
    busy = sum(per.values())
    print(f"[serve] {len(waves)} beats with GBT head, device ms per score: "
          + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
          + f"; device busy {busy:.4f} of {wall_ms:.4f} ms wall (profiled), idle share {1 - busy / wall_ms:.3f}")


def phase_serve(torch):
    from ae_waveforms_tpu_torch.bridge import gbt_from_numpy
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.ops.gbt_route import route_rows
    from ae_waveforms_tpu_torch.ops.lstm_encoder import encode_fused
    from ae_waveforms_tpu_torch.serve import Scorer
    from ae_waveforms_tpu_torch.train.checkpoint import save_state

    cfg = TrainConfig()  # LSTMAutoencoder 1->128->64->10, the repo's default model
    pool = synthetic_beats(np.random.default_rng(3), max(SIZES))
    gbt_params = dict(max_depth=6, n_estimators=100, learning_rate=0.3)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as results:
        model = LSTMAutoencoder(cfg.latent_size, generator=torch.Generator().manual_seed(0), device="cpu")
        save_state(os.path.join(results, "networks_autoencoder", RUN, "model_autoencoder.npz"), model.jax_tree())

        encode_fused.launches = route_rows.launches = 0
        scorer = Scorer.from_run(results, RUN, cfg)
        warm_s = scorer.warmup()
        plain = {n: scorer.score(pool[:n]) for n in SIZES}
        # a latent on a bin edge flips a leaf on a last-bit difference, so the
        # edges keep the latent tolerance away from every scored latent
        edges = separated_edges(plain[max(SIZES)]["latents"], 64, margin=LATENT_ATOL)
        gbt_arrays = random_gbt_arrays(np.random.default_rng(4))
        scorer.attach_gbt(gbt_from_numpy(**gbt_arrays, edges=edges, params=gbt_params))
        headed = {n: scorer.score(pool[:n]) for n in SIZES}
        launches = {"lstm_encoder": encode_fused.launches, "gbt_route": route_rows.launches}
        print(f"[serve] warmup {warm_s:.3f} s; launches during the serving run: {launches}")
        check(all(v > 0 for v in launches.values()), f"a kernel was not launched on the serving path: {launches}")

        encode_fused.launches = route_rows.launches = 0
        scorer.score(pool[:64])
        print(f"[serve] launches per score of 64 beats: lstm_encoder {encode_fused.launches}, "
              f"gbt_route {route_rows.launches}")

        for n in SIZES:
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                scorer.score(pool[:n])
                times.append(time.perf_counter() - t0)
            p50 = float(np.median(times))
            print(f"[serve] {n} beats (bucket 64, GBT head): p50 {p50 * 1e3:.3f} ms, {n / p50:.1f} beats/s")
        serve_breakdown(torch, scorer, pool[:64])

        cpu = Scorer.from_run(results, RUN, cfg, device="cpu")
        cpu_plain = {n: cpu.score(pool[:n]) for n in SIZES}
        cpu.attach_gbt(gbt_from_numpy(**gbt_arrays, edges=edges, params=gbt_params, device="cpu"))
        cpu_headed = {n: cpu.score(pool[:n]) for n in SIZES}

    tolerances = {"latents": LATENT_ATOL, "reconstruction": 1e-4, "probability": 1e-5}
    for label, gpu_out, cpu_out in (("AE", plain, cpu_plain), ("AE+GBT", headed, cpu_headed)):
        for n in SIZES:
            g, c = gpu_out[n], cpu_out[n]
            check(sorted(g) == sorted(c), f"key sets differ: {sorted(g)} vs {sorted(c)}")
            check(g["reconstruction"].shape == (n, T_BEAT) and g["latents"].shape == (n, cfg.latent_size),
                  f"shapes at {n} beats")
            check(all(np.all(np.isfinite(v)) for v in g.values()), f"non-finite output at {n} beats")
            errs = {k: float(np.abs(g[k] - c[k]).max()) for k in tolerances if k in g}
            print(f"[serve] {label} {n} beats vs CPU Scorer: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            check(all(v <= tolerances[k] for k, v in errs.items()), f"GPU and CPU Scorers disagree: {errs}")
    return launches


# (S, n, half, share of rows with g = h = 0): the grid search's chunks of 96
# fits at depth <= 6 and of 24 at depth <= 10, the PPV sweep's 25 seeds on
# 12,500 rows, a fit-like level (held-out and subsampled-out rows carry no
# weight: 1 - 0.67 * 0.8 = 46%) and the smoke grid's chunks of 6 fits
HIST_SHAPES = ([(96, 12000, half, 0.0) for half in (1, 2, 4, 8, 16)] + [(96, 12000, 16, 0.46)]
               + [(24, 12000, half, 0.0) for half in (32, 64, 128, 256)] + [(25, 12500, 16, 0.0)]
               + [(6, 12000, half, 0.46) for half in (1, 16, 256)])
HIST_SWEEP_SHAPE = (96, 12000, 16, 0.0)  # the grid search's depth <= 6 chunks, deepest level


def phase_hist(torch, dev):
    from ae_waveforms_tpu_torch.ops.gbt_hist import (
        active_clusters, fixed_point_shift, hist_plan, left_histograms, left_histograms_fixed,
        left_histograms_fixed_reference, left_histograms_reference, pack_bins,
    )

    from ae_waveforms_tpu_torch.ops import gbt_hist

    # the plan's mirror of the kernel's shared-memory layout
    kernel_cells = gbt_hist._library().gbt_hist_max_cells()
    check(kernel_cells == gbt_hist.MAX_CELLS, f"hist_plan assumes {gbt_hist.MAX_CELLS} cells a tile, the kernel "
                                               f"holds {kernel_cells}")
    # the clusters the card holds at once, by cluster size, which the wrapper plans with
    active = active_clusters(dev.index)
    print(f"[gbt_hist] cudaOccupancyMaxActiveClusters by cluster size {active}")
    rng = np.random.default_rng(5)
    F, n_bins = 10, 64
    result = {}
    for S, n, half, zero in HIST_SHAPES:
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        binsT = t(rng.integers(0, n_bins, size=(F, n)).astype(np.int32))
        keep = (rng.random((S, n)) >= zero).astype(np.float32)
        g = t(rng.uniform(-1, 1, (S, n)).astype(np.float32) * keep)
        h = t(rng.uniform(0, 0.25, (S, n)).astype(np.float32) * keep)
        node = t(rng.integers(0, 2 * half, size=(S, n)).astype(np.int32))
        shift = fixed_point_shift(g, h)
        packed = pack_bins(binsT, n_bins)  # as the fit packs its pool once
        kw = dict(half=half, n_bins=n_bins)
        q1 = left_histograms_fixed(binsT, g, h, node, shift, packed=packed, **kw)
        q2 = left_histograms_fixed(binsT, g, h, node, shift, packed=packed, **kw)
        exact = torch.equal(q1, left_histograms_fixed_reference(binsT, g, h, node, shift, **kw))
        got = left_histograms(binsT, g, h, node, shift=shift, **kw)
        ref = left_histograms_reference(binsT, g, h, node, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        close = bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
        where = f"S={S} n={n} half={half} zero rows {zero:.2f}"
        check(torch.equal(q1, q2), f"gbt_hist is not bit-identical across two calls at {where}")
        check(exact, f"gbt_hist fixed-point sums differ from the plain version at {where}")
        check(close, f"gbt_hist disagrees with the float64 plain version at {where}: {err}")

        plan = hist_plan(S, n, F, n_bins, half, active)
        ms = graph_ms(torch, lambda: left_histograms_fixed(binsT, g, h, node, shift, packed=packed, **kw), 20)
        f32_ms = graph_ms(torch, lambda: left_histograms(binsT, g, h, node, shift=shift, **kw), 20)
        plain_ms = graph_ms(torch, lambda: left_histograms_fixed_reference(binsT, g, h, node, shift, **kw), 3)
        # the JAX package's non-kernel path: one float32 contraction of the
        # (fit, row, child) g/h operand with the one-hot bins, built outside
        sel = (node[:, :, None] == 2 * torch.arange(half, device=dev)).float()
        A = torch.cat([sel * g[:, :, None], sel * h[:, :, None]], dim=2)
        onehot = (binsT.T[:, :, None] == torch.arange(n_bins, device=dev)).float().reshape(n, F * n_bins)
        library_ms = graph_ms(torch, lambda: torch.einsum("snc,nb->scb", A, onehot), 3)
        del sel, A, onehot
        # rows that add: a left child of the level with g or h not zero
        matched = int(((node % 2 == 0) & (node < 2 * half) & ((g != 0) | (h != 0))).sum().item())
        # bytes: bins (at the bytes a bin needs, one where n_bins <= 255), g,
        # h, node ids and shifts read once, the function's float32
        # histograms written once (the kernel's int64 write is a cost of its
        # design, printed beside); operations: a g and an h add per (row that
        # adds, feature)
        out_cells = S * 2 * half * F * n_bins
        in_bytes = (1 if n_bins <= 255 else 2) * F * n + 12 * S * n + 4 * S
        bound_ms, bound_by = bound(in_bytes + 4 * out_cells, 2 * F * matched)
        int64_bound_ms, _ = bound(in_bytes + 8 * out_cells, 2 * F * matched)
        print(f"[gbt_hist] {where}: fixed point exact and bit-identical, float32 max_abs_err {err:.3e} "
              f"(tolerance 1e-4 + 1e-5 |ref|); plan C={plan.cluster} tile {plan.node_tile} nodes x "
              f"{plan.feature_tile} features, {plan.walks} walks, {plan.clusters} clusters of {plan.threads} "
              f"threads, {plan.smem_bytes} bytes per block, cudaOccupancyMaxActiveClusters {active[plan.cluster]}; "
              f"device ms per call (CUDA graph): kernel {ms:.5f}, float32 entry (packs per call) {f32_ms:.5f}, "
              f"plain {plain_ms:.5f}, einsum {library_ms:.5f}; bound {bound_ms:.6f} ms by {bound_by} "
              f"({int64_bound_ms:.6f} ms with an int64 write)")
        if (S, n, half, zero) == HIST_SWEEP_SHAPE:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, plan=plan._asdict(), max_active_clusters=active[plan.cluster])
    return result


def write_latent_dir(d: str, n_per: int = 6500, F: int = 10, seed: int = 6) -> None:
    """The classify CLI's inputs: np_info.npy, np_latent_spaces_mimiciv.npy,
    controls.csv and hypopotassium.csv.  Latents are seeded Gaussians, the
    sick cases' means shifted on four of the ten latents."""
    rng = np.random.default_rng(seed)
    shift = np.where(np.arange(F) < 4, 0.3, 0.0)
    latents = np.concatenate([rng.standard_normal((n_per, F)),
                              rng.standard_normal((n_per, F)) + shift]).astype(np.float32)
    ids = np.arange(2 * n_per) + 100000
    np.save(os.path.join(d, "np_info.npy"), np.stack([ids, 2000 * np.arange(2 * n_per)], 1).astype(np.float64))
    np.save(os.path.join(d, "np_latent_spaces_mimiciv.npy"), latents)
    for name, part in (("controls.csv", ids[:n_per]), ("hypopotassium.csv", ids[n_per:])):
        with open(os.path.join(d, name), "w") as f:
            f.write("idx,caseid\n" + "".join(f"{i},{c}\n" for i, c in enumerate(part)))


def phase_classify(torch):
    from ae_waveforms_tpu_torch.classify.lhs import lhs_param_dicts
    from ae_waveforms_tpu_torch.cli import classify as cli
    from ae_waveforms_tpu_torch.ops.gbt_hist import left_histograms_fixed
    from ae_waveforms_tpu_torch.ops.gbt_route import route_rows

    n_candidates, n_seeds = 12, 25
    cands = lhs_param_dicts(n_candidates, random_state=1)  # the CLI's grid
    print("[classify] candidates (max_depth, n_estimators): "
          + ", ".join(f"({p['max_depth']}, {p['n_estimators']})" for p in cands))
    timed = {}

    def timing(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timed[name] = (time.perf_counter() - t0, out)
            return out
        return run

    originals = cli.grid_search_cv, cli.ppv_analysis
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        write_latent_dir(d)
        cli.grid_search_cv, cli.ppv_analysis = timing("grid", originals[0]), timing("ppv", originals[1])
        left_histograms_fixed.launches = route_rows.launches = 0
        try:
            result = cli.main(["ppv", "--data", d, "--vectorized", "--gs_candidates", str(n_candidates),
                               "--seeds", str(n_seeds)])
        finally:
            cli.grid_search_cv, cli.ppv_analysis = originals
        launches = {"gbt_hist": left_histograms_fixed.launches, "gbt_route": route_rows.launches}
    print(f"[classify] launches during the classify run: {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched on the classify path: {launches}")
    grid_s, gs = timed["grid"]
    ppv_s, _ = timed["ppv"]
    best = gs["best_params"]
    fold_fits = 3 * n_candidates
    cap = max(p["n_estimators"] for p in cands)
    print(f"[classify] grid search: {grid_s:.3f} s wall for {fold_fits} fold-fits of {cap} trees on 12,000 rows "
          f"({fold_fits / grid_s:.3f} fold-fits/s, {grid_s * 1e3 / (fold_fits * cap):.4f} ms per tree per fit); "
          f"best CV AUC {gs['best_score']:.4f} at {best}")
    print(f"[classify] PPV sweep: {ppv_s:.3f} s wall for {n_seeds} seeds x {best['n_estimators']} trees of depth "
          f"{best['max_depth']} on a 12,500-row pool ({ppv_s * 1e3 / (n_seeds * best['n_estimators']):.4f} "
          f"ms per tree per fit)")
    print(f"[classify] median AUC {result['median_auc']:.4f} (IQR {result['q1_auc']:.4f}-{result['q3_auc']:.4f}), "
          f"median PPV {result['median_ppv']:.4f} (IQR {result['q1_ppv']:.4f}-{result['q3_ppv']:.4f})")
    fit_breakdown(torch, torch.device("cuda:0"), S=96, depth=6, trees=20)
    fit_breakdown(torch, torch.device("cuda:0"), S=24, depth=10, trees=10)
    values = np.array(result["aucs"] + result["ppvs"], np.float64)
    check(len(result["aucs"]) == n_seeds and np.all(np.isfinite(values)), "non-finite or missing AUC/PPV")
    check(0.5 < result["median_auc"] <= 1.0 and 0.0 < result["median_ppv"] <= 1.0,
          f"the classifier does not separate the shifted classes: {result['median_auc']}")
    return launches


def fit_breakdown(torch, dev, S: int, depth: int, trees: int, n: int = 12000, F: int = 10) -> None:
    """Where a fit's time goes on the card: device ms per tree by kernel
    group (torch.profiler) and the device's idle share of the wall time,
    for S fits of ``trees`` trees at ``depth`` on n random rows."""
    from torch.profiler import ProfilerActivity, profile

    from ae_waveforms_tpu_torch.classify.gbt import fit_gbt_sweep_margins

    rng = np.random.default_rng(8)
    bins = torch.from_numpy(rng.integers(0, 64, size=(n, F)).astype(np.int32)).to(dev)
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.random((S, n)) < 0.67).astype(np.float32)).to(dev)

    def fit():
        return fit_gbt_sweep_margins(bins, y, w, np.arange(S), [0.1] * S, [0.0] * S, [1.0] * S, [0.8] * S,
                                     [0.8] * S, [trees] * S, max_depth=depth, n_estimators=trees)

    fit()
    torch.cuda.synchronize()
    groups = {"gbt_hist": ("gbt_hist_kernel",), "gbt_route": ("gbt_route_kernel",), "copies": ("Memcpy", "Memset")}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {e.key: e.count for e in prof.key_averages()}
    seen = {g: sum(c for k, c in counts.items() if groups[g][0] in k) for g in ("gbt_hist", "gbt_route")}
    if seen != {"gbt_hist": trees * depth, "gbt_route": trees * depth}:
        print(f"[classify] fit breakdown not measured: torch.profiler recorded {seen} of "
              f"{trees * depth} launches of each kernel")
        return
    per = dict.fromkeys([*groups, "epilogue and other kernels"], 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "epilogue and other kernels")
        per[name] += us / trees / 1e3
    busy = sum(per.values())
    print(f"[classify] fit of {S} fits x {n} rows, depth {depth}, device ms per tree: "
          + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
          + f"; device busy {busy:.4f} of {wall_ms / trees:.4f} ms wall per tree (profiled), "
          f"idle share {1 - busy * trees / wall_ms:.3f}")


def _split_gains(bins, g, h, rows, splits):
    """Host float64 gains of the candidate (feature, bin) splits of one
    node's rows: 0.5 * (GL^2/(HL+1) + GR^2/(HR+1) - G^2/(H+1))."""
    out = []
    for f, b in splits:
        left = rows & (bins[:, f] <= b)
        right = rows & (bins[:, f] > b)
        GL, HL, GR, HR = g[left].sum(), h[left].sum(), g[right].sum(), h[right].sum()
        out.append(0.5 * (GL**2 / (HL + 1) + GR**2 / (HR + 1) - (GL + GR) ** 2 / (HL + HR + 1)))
    return out


def phase_determinism(torch, dev):
    from ae_waveforms_tpu_torch.classify import gbt

    rng = np.random.default_rng(7)
    S, n, F, depth, trees = 4, 2000, 10, 6, 20
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = (X[:, 0] - 0.7 * X[:, 3] + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    weights = (rng.random((S, n)) < 0.7).astype(np.float32)
    bins = gbt.bin_data(torch.from_numpy(X), torch.from_numpy(gbt.compute_bin_edges(X))).numpy()
    hp = dict(learning_rates=[0.3] * S, gammas=[0.0] * S, min_child_weights=[1.0] * S, subsamples=[0.8] * S,
              colsamples=[0.8] * S, n_actives=[trees] * S)

    def fit(device):
        return gbt.fit_gbt_sweep_margins(torch.from_numpy(bins).to(device), y, weights, np.arange(S),
                                         *hp.values(), max_depth=depth, n_estimators=trees)

    a, b, c = fit(dev), fit(dev), fit("cpu")
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip((*a[0], a[1]), (*b[0], b[1])))
    print(f"[determinism] two card fits ({S} fits, {n} rows, depth {depth}, {trees} trees, subsample and colsample "
          f"0.8): ensembles and margins bit-identical: {same}")
    check(same, "two card fits of the same inputs differ")
    for name in ("feat", "thresh", "is_split"):
        ga, gc = getattr(a[0], name).cpu().numpy(), getattr(c[0], name).numpy()
        if not np.array_equal(ga, gc):
            s, t, k = (int(v) for v in np.argwhere(ga != gc)[0])
            splits = [(int(a[0].feat[s, t, k]), int(a[0].thresh[s, t, k])), (int(c[0].feat[s, t, k]), int(c[0].thresh[s, t, k]))]
            prior = gbt.GBTEnsemble(*(x[s, :t] for x in c[0][:4]), lr=c[0].lr[s])
            m = gbt.predict_margin(prior, torch.from_numpy(bins), depth).double().numpy() if t else np.zeros(n)
            p = 1 / (1 + np.exp(-m))
            w = weights[s] * (gbt.subsample_uniforms(torch.tensor([s]), t, n, gbt._ROW_STREAM)[0].numpy() < 0.8)
            level = int(np.log2(k + 1))
            node = np.zeros(n, np.int64)  # every row's node at the differing node's level
            cf, ct, cs = (x[s, t].numpy() for x in c[0][:3])
            for d in range(level):
                kk = 2**d - 1 + node
                node = np.where(cs[kk], 2 * node + (bins[np.arange(n), cf[kk]] > ct[kk]), 2 * node)
            rows = node == k - (2**level - 1)
            gains = _split_gains(bins, (p - y) * w, np.maximum(p * (1 - p), 1e-16) * w, rows, splits)
            print(f"[determinism] first differing node: fit {s}, tree {t}, heap slot {k}: card (feature, bin) "
                  f"{splits[0]} gain {gains[0]!r}, CPU {splits[1]} gain {gains[1]!r}")
            raise SmokeFailure(f"card and CPU fits grow different trees ({name})")
    err = float((a[1].cpu() - c[1]).abs().max())
    print(f"[determinism] card against CPU: feat, thresh and is_split equal; margins max_abs_err {err:.3e} "
          f"(tolerance 5e-3)")
    check(err <= 5e-3, f"card and CPU margins differ by {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    from ae_waveforms_tpu_torch import full_fp32
    from ae_waveforms_tpu_torch.ops import _build

    full_fp32()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch.cuda.get_device_name(0) = {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNELS)} kernels built in {time.perf_counter() - t0:.2f} s")
    for name in _build.KERNELS:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.is_file():
            print(f"[build] {name}: " + " | ".join(line.strip() for line in log.read_text().splitlines() if line.strip()))

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s wall")
        return out

    encoder = timed("2 lstm_encoder", phase_encoder, torch, dev)
    route = timed("3 gbt_route", phase_route, torch, dev)
    serve_launches = timed("4 serving", phase_serve, torch)
    hist = timed("5 gbt_hist", phase_hist, torch, dev)
    classify_launches = timed("6 classify", phase_classify, torch)
    timed("7 determinism", phase_determinism, torch, dev)

    kernels = [
        dict(name="lstm_encoder", route="cuda", source="ae_waveforms_tpu_torch/csrc/lstm_encoder.cu",
             replaces="ae_waveforms_tpu/ops/lstm_pallas.py:109", launches=serve_launches["lstm_encoder"], **encoder),
        dict(name="gbt_route", route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_route.cu",
             replaces="ae_waveforms_tpu/ops/gbt_route_pallas.py:167",
             launches=serve_launches["gbt_route"] + classify_launches["gbt_route"], **route),
        dict(name="gbt_hist", route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_hist.cu",
             replaces="ae_waveforms_tpu/ops/gbt_hist_pallas.py:193", launches=classify_launches["gbt_hist"], **hist),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
