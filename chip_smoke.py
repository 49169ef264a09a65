"""Smoke run of the PyTorch/CUDA port (``ae_waveforms_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device and build: the card's name and power limit; the five CUDA
   kernel sources built from ``ae_waveforms_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. the fused LSTM encoder kernel (8-block clusters) against its plain
   version at the serving shape (B=64, T=320, 1->128->64->10), at latent 2
   and 20, at B=1, at B=128 (the trainer's validation and test batch) and
   at B=256 (the 200-beat request's bucket), within 2e-5; at B=64, 128 and
   256 its launch plan and cudaOccupancyMaxActiveClusters,
   and its time beside the plain version and a ``torch.nn.LSTM`` stack
   computing the same latent (device time per call from a CUDA graph of
   many calls, and per phase of its time loop; time per call with launch
   gaps from CUDA events).
3. the GBT routing kernel against its plain version, exactly, also with
   bins and thresholds across int32 (staged and in place): one level
   at the serving head's widths (100 trees, 64 and 256 rows, 1..32 nodes),
   one 1024-node level and the fit's deepest levels (96 fits x 12,500 rows
   at 32 nodes, the deep bucket's 24 x 12,000 at 512, the PPV sweep's 25 x
   12,500 at 128); every level of a tree heap in one launch (the serving
   head's 100 trees of depth 6 on 64 and 256 rows, the PPV prediction's
   12,500 trees of depth 8 on 500 rows) and levels [2, 6) from mid-heap
   ids.  Prints each launch's plan and its time beside the plain version
   and its bound.
4. the serving path through its entry points: a run directory written with
   the port's ``save_state``, ``Scorer.from_run`` -> ``warmup`` ->
   ``score`` for 1, 37, 64 and 200 beats, then again with a 100-tree
   depth-6 GBT head attached through the bridge.  Both kernels' launch
   counts must rise during the run, a 64-beat score must route its trees
   in one launch, and every output must match the same ``Scorer`` on the
   CPU (latents 2e-5, reconstruction 1e-4, probability 1e-5), with the
   process's TF32 flags at torch's defaults: the model keeps its own
   precision.  Prints p50 latency and beats/s per request size, and where
   the device time of a 64-beat score goes, by kernel, with the idle share.
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
   harness at full width.  The histogram, split and routing kernels' launch
   counts must rise, the routing kernel's by one a fit level (as the
   histogram and split kernels') and one for the PPV sweep's prediction,
   and the per-tree kernels' (K5, K6) by one a tree each.  Prints the
   grid search's and PPV sweep's wall seconds, fold-fits per second, ms per
   tree per fit and the median AUC and PPV.
7. determinism: a 4-fit sweep on 2,000 rows, fitted twice on the card
   (bit-identical ensembles and margins, the split kernel launched once a
   level of each) and once on the CPU (the same trees, margins within
   5e-3).
8. AE train and test through ``cli.main_ae`` at the default model's full
   width (B=128, T=320, Adam, StepLR, mse, dropout 0.2): 16,384 synthetic
   beats over 128 case ids, ``-m train`` for 2 epochs (validation every 25
   steps), then ``-m test`` on its run.  Every loss must be finite, the last
   validation loss below the first, every weight moved from its init, every
   step after the first replayed from one captured graph, the encoder
   kernel launched once per validation and test batch, and the test
   pass's latents and reconstructions within 2e-5 and 1e-4 of the CPU's
   ``main_test`` on the same run.  From one init with dropout 0, 10 steps at
   B=32 on the card, again on the card and on the CPU: losses within rtol
   5e-4, atol 5e-5 of the CPU's, and within 1e-5 relative of each other.
   With both TF32 flags on, one step's gradients on the card within 1e-4
   of each leaf's largest on the CPU, and the same backward in TF32 must
   miss that.  Prints ms per train step (p50 from CUDA events, outside the
   profiled steps), beats/s, the host's time to issue a step, ms per
   validation, the test pass's wall ms and latents/s, where 20 steps'
   device time goes by group (where the steps run eager: torch.profiler
   links a replayed graph's kernels to no op), with the idle share and the
   optimizer's host time, and Adam's host time beside
   ``torch.optim.Adam(fused=True)``'s, whose 10 steps are held against the
   CPU's.  The beats' np_features hold fiducials at the generator's wave
   centres (about 5% of P's dropped), which training never reads.
9. the conv autoencoder and the reconstruction study, on phase 8's data
   and LSTM run: ``cli.main_ae -m train --model_class
   LeNet5AutoencoderAvgPool`` (1->16->32->64->128->10, the same cut and
   defaults as phase 8) with the same readings and checks (its device
   split by conv forward, conv backward, upsample and its backward,
   dropout, optimizer, gather and loss); ``-m test`` against the CPU's
   ``main_test``; 10 steps twice on the card and once on the CPU; one
   step's gradients with both TF32 flags on against the CPU's, and a step
   whose forward and backward run outside ``cudnn_fp32`` must miss;
   ``Scorer.from_run`` of the conv
   run with phase 4's GBT head against the CPU ``Scorer`` (latents (n, 10)
   within 2e-5), the 64-beat p50; ``analysis.trad_vs_ae.compare`` with
   the 2,000-candidate sigma sweep on the test split and both runs,
   timed by part (sweep wall s, candidates/s, the final reconstruction,
   each test pass), its table, the card's objective on 64 candidates
   against the CPU's (rtol 1e-5 + atol 1e-7) and its final
   reconstruction against the CPU's (5e-5); then ``cli.analysis --search
   gp --search_calls 200`` with the LSTM run, timed.
10. extraction, from synthetic one-hour ECG records to np_waves /
   np_features / np_info: the float64 host engine on the JAX package's
   goldens (waves 1e-6, windows and NaN patterns equal, features 1e-7: the
   reference's ba-form scipy filter parts by ~1e-8 across scipy builds, and
   the line prints it) and the device delineator on the golden windows'
   frozen fiducials; ``cli.extract --cases 24 --duration 3600`` (float64,
   the C++ delineator, 4,320 windows) and the same command again, which must
   read its cache and write byte-identical arrays; the device engine
   (``extract_cases(batched=True)``, float32, ``filter_backend="device"``,
   chunks of 512) over the same records, a 160-bpm one (the full-width
   re-run must happen) and one with 3 NaN gaps, against the host engine on
   every record (kept windows equal, median beats within 1e-5), then again
   under torch.profiler for the idle share; one chunk pass alone (kernels,
   ms, peak memory); the device delineator against the C++ one on every
   kept window of the host engine's cases (exact >= 0.995, PARITY.md) and
   every device stage on two cases' windows on the card against the CPU
   (R peaks, counts, QC mask and fiducials equal, medians 1e-6, features
   1e-5).  Prints each engine's windows/s and wall s, the host and device
   time of each stage, launches and host syncs per chunk, peak device
   memory.
11. many models at once (``train/stacked.py``), on phase 8's data and
   step time: with both TF32 flags on, one stacked step of each trainer
   (2 configs at B=32) against the same step in float64 on the CPU by the
   LSTM leaves' gradients (within 1e-3 and a tenth of the error of a
   backward outside ``cudnn_fp32``, which is run beside it), and no cuDNN
   weight-copy warning; the working set of one step (the classifier at
   B=512 without and with remat, the autoencoder at B=128) beside
   ``core/hbm.py``'s count; ``cli.classify deep --sizes 500 11500 --seeds
   25 --epochs 2 --vectorized --remat_chunk 0`` on 12,000 synthetic beats
   a class (25 seeds stacked, B=512, T=320, 1->128->64->64): its AUCs
   finite, ms per stacked step, model-epochs/s, idle share; at size 1,000
   one epoch stacked without and with remat and one seed after another,
   wall and peak memory beside the count; two seeds from one init, dropout
   0, stacked on the card, each alone on the card (bit-identical) and on
   the CPU (probabilities within 1e-3); ``cli.main_ae -m train --seeds
   0,1,2,3 --lr_sweep 1,0.5`` and ``--latent_sizes 10,20`` (1 epoch) and
   ``-m test`` of one run, which launches the encoder kernel: ms per
   stacked step beside S x phase 8's step, configs x steps/s, idle share,
   peak memory beside the count; two configs from one init, dropout 0,
   together against each alone on the card (bit-identical) and on the CPU
   (phase 8's tolerances), and a run resumed from its checkpoint against
   the uninterrupted one (bit-identical).
12. several ranks (``parallel/``, one process a rank, on phase 8's beats):
   (a) one NCCL rank on cuda:0 runs 20 sharded train steps of the default
   LSTM AE at B=128 (``sharded_train_step``: dropout drawn for the whole
   batch, one all-reduce of the gradients and the loss), held against the
   same 20 single-device steps in this process (losses within 1e-5
   relative, params within rtol 2e-4 + atol 2e-5); prints ms per step
   beside phase 8's, the all-reduce's time on the gradient buffer and the
   MFU (``core/flops.py``; also printed for phases 8, 9 and 11).  (b) two
   gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card; their
   times are no measurement of a user path): the AE step split 64 + 64
   (losses 2e-5), an 8-seed fit of 100 depth-6 trees split 4 + 4 (exact), 2 configs of
   ``train_ae_multi`` (bit-identical), a 2-record extraction in chunks of
   8 windows (byte-equal) and the tensor-parallel pair on a (1, 2) grid
   against the unsharded MLP (1e-6; its SGD step 1e-5 + 1e-6), each against
   its one-device run.  The ranks' launches of K1 to K6 join the
   ``kernels`` line; each must be above 0, K4's equal K1's (one a fit
   level) and K6's K5's (one a tree).
13. end to end (``ae_waveforms_tpu_torch.examples.run_e2e`` at the JAX
   example's defaults: 12 synthetic 120-s records, the conv AE at full
   width for 2 epochs): ``cli.extract`` -> ``main_train`` -> ``main_test``
   with the latents -> the test split copied into the data dir ->
   ``compare`` with the 128-candidate sigma sweep -> the GBT grid search (4
   LHS candidates x 2 folds) and a 3-seed PPV sweep on the latents, then the
   resume-and-serve flow (4 steps, resumed to 8 from the full train state,
   ``Scorer.from_run`` on 10 beats with a 10-tree depth-2 GBT head), all on
   the card; then the chain again on the CPU.  The extracted arrays must be
   byte-equal and the split masks equal, card against CPU, and the study's
   traditional MSE and RMSE within phase 9's objective tolerance; the test
   RMSE finite, the median PPV above 0.8, the resumed step above 0 and the
   head's probabilities in [0, 1].  K1's, K2's, K4's, K5's and K6's
   launches on the card must equal the count the code gives, and join the
   ``kernels`` line.
   Prints each stage's wall seconds.
14. the GBT split kernel (K4, ``ops/gbt_split.py``) at the fit's widest
   levels (the grid search's 27 fits at depth 5 and 21 at depth 9, the
   study's 96 and 24, the PPV sweep's 25 at depth 7, one fit on 149 rows at
   depth 8), each as an inner and as the last level, on K1's sums of 12,000
   rows (149 for the one fit) routed at random: the node histograms or
   leaf sums and the heap slots bit-identical to its plain version's and
   across two calls.  Times the kernel (device ms per call from a CUDA
   graph, and per call with launch gaps from CUDA events) beside the plain
   version and its bound by bytes.
15. the GBT per-tree kernels (``ops/gbt_tree.py``: K5 ``tree_grad``, the
   masks, g, h, shifts and node ids; K6 ``tree_leaves``, the leaf weights
   and margins) at the fit's chunks (the grid search's 27 fits to depth 6
   and 21 to depth 10, the study's 96, the PPV sweep's 25 on 12,500 rows
   to depth 8, one fit on 149 rows), K5 with drawn and with injected
   masks: every output bit-identical to its plain version's and across two
   calls.  Times each kernel beside its plain version and its bound by
   bytes, as phase 14.

Prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.  Weights, beats and latents are random, made from
seeds.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ae_waveforms_tpu_torch.ops import _build  # noqa: E402
from ae_waveforms_tpu_torch.tools.common import event_ms, graph_ms, heap_inputs, route_inputs  # noqa: E402

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


def launched(before: dict) -> dict:
    """Each kernel's launches since ``before``, a copy of ``_build.launches``."""
    return {k: v - before[k] for k, v in _build.launches.items()}


def bound(nbytes: float, flops: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def train_flops(model_class: str) -> int:
    """FLOPs of a train step a beat of ``model_class`` at latent 10 (core/flops.py)."""
    from ae_waveforms_tpu_torch.core import flops

    return (flops.lstm_ae_train_flops_per_sample() if model_class == "LSTMAutoencoder"
            else flops.conv_ae_train_flops_per_sample())


def mfu_of(torch, step_flops: float, ms: float) -> float:
    """A step's achieved FLOP/s over this card's float32 peak (core/flops.py's table)."""
    from ae_waveforms_tpu_torch.core import flops

    return flops.mfu(step_flops / (ms * 1e-3), torch.cuda.get_device_name(0))


R_SAMPLE = 106  # the R peak's sample in a beat, a third of it, as the extractor cuts them
WAVE_WIDTHS = (10, 3, 4, 3, 20)  # the P, Q, R, S and T bumps' widths in samples


def synthetic_beats_and_centres(rng, n: int):
    """ECG-like median beats (P, Q, R, S, T bumps, R at a third of the
    beat) with seeded jitter, amplitude, baseline offset and noise, and the
    bumps' centres in samples (n, 5)."""
    t = np.arange(T_BEAT, dtype=np.float64)
    g = lambda c, w: np.exp(-0.5 * ((t[None, :] - c) / w) ** 2)  # noqa: E731
    a = rng.uniform(0.7, 1.3, size=(n, 5))
    j = rng.normal(0.0, 4.0, size=(n, 2))
    wp, wq, wr, ws, wt = WAVE_WIDTHS
    waves = (0.15 * a[:, :1] * g(60 + j[:, :1], wp) - 0.1 * a[:, 1:2] * g(98, wq)
             + a[:, 2:3] * g(R_SAMPLE, wr) - 0.2 * a[:, 3:4] * g(114, ws)
             + 0.3 * a[:, 4:5] * g(210 + j[:, 1:], wt))
    waves = waves * rng.uniform(0.3, 3.0, size=(n, 1)) + rng.normal(0.0, 0.5, size=(n, 1))
    waves = (waves + 0.02 * rng.standard_normal((n, T_BEAT))).astype(np.float32)
    fixed = np.ones((n, 1))
    centres = np.concatenate([60 + j[:, :1], 98 * fixed, R_SAMPLE * fixed, 114 * fixed, 210 + j[:, 1:]], 1)
    return waves, centres


def synthetic_beats(rng, n: int) -> np.ndarray:
    return synthetic_beats_and_centres(rng, n)[0]


def beat_fiducials(waves: np.ndarray, centres: np.ndarray, rng) -> np.ndarray:
    """(n, 35) feature rows: the 10 fiducials of ``core/schema.py``'s
    order (P peak, onset, offset; Q; R onset, offset; S; T peak, onset,
    offset) at the generator's centres, onsets and offsets two widths out
    (the R wave's 1.5), each as x in ms from R (500 Hz) and y the beat's
    value there minus its value at R; about 5% of the P fiducials NaN, as a
    delineator drops them; the morphology columns 0."""
    wp, _, wr, _, wt = WAVE_WIDTHS
    p, q, r, s, t = centres.T
    at = np.stack([p, p - 2 * wp, p + 2 * wp, q, r - 1.5 * wr, r + 1.5 * wr, s, t, t - 2 * wt, t + 2 * wt], 1)
    idx = np.clip(np.rint(at), 0, T_BEAT - 1).astype(np.int64)
    rows = np.arange(len(waves))[:, None]
    x = (idx - R_SAMPLE) * 1000.0 / 500
    y = waves[rows, idx].astype(np.float64) - waves[:, R_SAMPLE:R_SAMPLE + 1]
    dropped = rng.random((len(waves), 3)) < 0.05
    x[:, :3][dropped] = np.nan
    y[:, :3][dropped] = np.nan
    features = np.zeros((len(waves), 35))
    features[:, 0:20:2], features[:, 1:20:2] = x, y
    return features


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
    from ae_waveforms_tpu_torch import cudnn_fp32
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.ops.lstm_encoder import (
        CLUSTER, encode_fused, encode_fused_reference, encoder_plan, max_active_clusters,
    )

    beats = {64: synthetic_beats(np.random.default_rng(1), 64),
             256: synthetic_beats(np.random.default_rng(9), 256)}
    H1, H2 = 128, 64
    phases = T_BEAT + 2  # the kernel's skewed time loop: one cluster barrier per phase
    result = {}
    for B, latent in ((64, 10), (64, 2), (64, 20), (1, 10), (128, 10), (256, 10)):
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

        def library():  # cuDNN in full float32, as the kernel computes
            h = x
            with cudnn_fp32():
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
        else:  # the trainer's validation and test batch, and the 200-beat request's bucket
            result[f"at_B{B}"] = dict(max_abs_err=err, **timing)
    return result


# bins and thresholds anywhere in int32, past 2^23 and 2^24 and at the ends
INT32_EDGES = np.array([-2**31, -2**31 + 1, -2**24 - 1, -2**24, -2**23, -1, 0, 1, 2**23 - 1, 2**23, 2**24,
                        2**24 + 1, 2**31 - 2, 2**31 - 1], np.int64)


# one level (S, n, nodes): the serving head's levels, a 1024-node level and
# the fit's deepest: the grid search's depth <= 6 chunks (ROUTE_FIT_SHAPE,
# 28,000 of a classify run's launches are such levels), the deep bucket's 24
# fits at 512 nodes and the PPV sweep's 25 seeds at 128
ROUTE_FIT_SHAPE = (96, 12500, 32)
# and phase 13's single fits, one level of one fit: a grid-search fold's 149
# rows (depth up to 10), a PPV seed's 128 and the flow head's 20
ROUTE_LEVEL_SHAPES = ([(100, n, 2**d) for n in (64, 256) for d in range(6)]
                      + [(100, 256, 1024), ROUTE_FIT_SHAPE, (24, 12000, 512), (25, 12500, 128)]
                      + [(1, n, 2**d) for n, depth in ((149, 10), (128, 3), (20, 2)) for d in range(depth)])
# levels [d0, d1) in one launch (S, n, d0, d1): the serving head's 100 trees
# of depth 6 (ROUTE_SERVE_SHAPE, one launch a score), the PPV sweep's
# prediction (25 seeds x 500 trees of depth 8 on 500 test rows), mid-heap,
# and phase 13's predictions: a grid-search fold's 149 held-out rows through
# 400 trees of depth 3 and 250 of depth 10, a PPV seed's 49 test rows, and
# the flow head's 10 trees of depth 2 on 10 beats
ROUTE_SERVE_SHAPE = (100, 64, 0, 6)
ROUTE_HEAP_SHAPES = [ROUTE_SERVE_SHAPE, (100, 256, 0, 6), (12500, 500, 0, 8), (100, 256, 2, 6),
                     (400, 149, 0, 3), (250, 149, 0, 10), (400, 49, 0, 3), (10, 10, 0, 2)]


def phase_route(torch, dev):
    from ae_waveforms_tpu_torch.ops.gbt_route import (
        route_levels, route_levels_reference, route_plan, route_rows, route_rows_reference,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(2)
    cases = ([("rows", shape, route_inputs(torch, dev, rng, *shape)) for shape in ROUTE_LEVEL_SHAPES]
             + [("levels", shape, heap_inputs(torch, dev, rng, *shape)) for shape in ROUTE_HEAP_SHAPES])
    # bins and thresholds anywhere in int32: the decision stays the integer
    # compare, staged (the fit's shape, a heap) and in place (a small launch)
    for kind, shape, inputs in (("rows", ROUTE_FIT_SHAPE, route_inputs), ("rows", (100, 64, 32), route_inputs),
                                ("levels", ROUTE_SERVE_SHAPE, heap_inputs)):
        args = inputs(torch, dev, rng, *shape, edges=INT32_EDGES)
        fn, ref_fn = (route_rows, route_rows_reference) if kind == "rows" else (route_levels, route_levels_reference)
        mismatches = int((fn(*args) != ref_fn(*args)).sum().item())
        print(f"[gbt_route] {kind} {shape}, bins and thresholds across int32: {mismatches} rows differ")
        check(mismatches == 0, f"gbt_route differs at {shape} with bins and thresholds across int32")
    result = {}
    for kind, shape, args in cases:
        fn, ref_fn = (route_rows, route_rows_reference) if kind == "rows" else (route_levels, route_levels_reference)
        got = fn(*args)
        ref = ref_fn(*args)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum().item())
        F = args[0].shape[0]
        if kind == "rows":
            S, n, width = shape
            levels, node_in, where = 1, True, f"S={S} n={n} one level of {width} nodes"
        else:
            S, n, d0, d1 = shape
            width, levels, node_in = 2**d0, d1 - d0, d0 > 0
            where = f"S={S} n={n} levels [{d0}, {d1}) in one launch"
        check(mismatches == 0, f"gbt_route differs at {where}: {mismatches} rows")
        plan = route_plan(S, n, F, levels, width, sms)
        big = S * n > 10**6
        ms = graph_ms(torch, lambda: fn(*args), 20 if big else 50)
        plain_ms = graph_ms(torch, lambda: ref_fn(*args), 3 if big else 20)
        call_ms = event_ms(torch, lambda: fn(*args), 50)
        # bytes: the pool and the node ids out, the ids in (none from the
        # root), the levels' splits (feature, bin, flag: 9 bytes a node);
        # operations: a compare, a shift and an add per row and level
        nodes = width * (2**levels - 1)
        bound_ms, bound_by = bound(4 * F * n + 4 * S * n * (2 if node_in else 1) + 9 * S * nodes, 3 * S * n * levels)
        print(f"[gbt_route] {where}: exact; plan {plan.chunk} fits x {plan.tile} rows a block "
              f"({'staged' if plan.staged else 'in place'}, {plan.vec} ids a task), {plan.blocks} blocks of "
              f"{plan.threads} threads, {plan.smem_bytes} bytes; device ms per call (CUDA graph): kernel {ms:.5f}, "
              f"plain {plain_ms:.5f}; kernel per call with launch gaps {call_ms:.5f}; bound {bound_ms:.6f} ms by "
              f"{bound_by} (kernel {ms / bound_ms:.2f}x)")
        timing = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                      plan=plan._asdict())
        if kind == "rows" and shape == ROUTE_FIT_SHAPE:  # the kernels line's numbers
            result.update(timing)
        elif kind == "levels" and shape == ROUTE_SERVE_SHAPE:
            result["at_serving"] = timing
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
    if seen != {"lstm_encoder": reps, "gbt_route": reps}:
        print(f"[serve] breakdown not measured: torch.profiler recorded {seen} of "
              f"{{'lstm_encoder': {reps}, 'gbt_route': {reps}}} launches")
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
    from ae_waveforms_tpu_torch.serve import Scorer
    from ae_waveforms_tpu_torch.train.checkpoint import save_state

    cfg = TrainConfig()  # LSTMAutoencoder 1->128->64->10, the repo's default model
    pool = synthetic_beats(np.random.default_rng(3), max(SIZES))
    gbt_params = dict(max_depth=6, n_estimators=100, learning_rate=0.3)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as results:
        model = LSTMAutoencoder(cfg.latent_size, generator=torch.Generator().manual_seed(0), device="cpu")
        save_state(os.path.join(results, "networks_autoencoder", RUN, "model_autoencoder.npz"), model.jax_tree())

        before = dict(_build.launches)
        scorer = Scorer.from_run(results, RUN, cfg)
        warm_s = scorer.warmup()
        plain = {n: scorer.score(pool[:n]) for n in SIZES}
        # a latent on a bin edge flips a leaf on a last-bit difference, so the
        # edges keep the latent tolerance away from every scored latent
        edges = separated_edges(plain[max(SIZES)]["latents"], 64, margin=LATENT_ATOL)
        gbt_arrays = random_gbt_arrays(np.random.default_rng(4))
        scorer.attach_gbt(gbt_from_numpy(**gbt_arrays, edges=edges, params=gbt_params))
        headed = {n: scorer.score(pool[:n]) for n in SIZES}
        launches = {k: v for k, v in launched(before).items() if k in ("lstm_encoder", "gbt_route")}
        print(f"[serve] warmup {warm_s:.3f} s; launches during the serving run: {launches}")
        check(all(v > 0 for v in launches.values()), f"a kernel was not launched on the serving path: {launches}")

        before = dict(_build.launches)
        scorer.score(pool[:64])
        per_score = launched(before)
        print(f"[serve] launches per score of 64 beats: lstm_encoder {per_score['lstm_encoder']}, "
              f"gbt_route {per_score['gbt_route']}")
        check(per_score["lstm_encoder"] == per_score["gbt_route"] == 1, "a score launches each kernel once")

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
# weight: 1 - 0.67 * 0.8 = 46%), the smoke grid's chunks of 6 fits, and
# phase 13's single fits (E2E_FIT_SHAPES)
E2E_FIT_SHAPES = [(1, 149, half, 0.3) for half in (1, 2, 16, 128, 256)] + [(1, 128, 2, 0.05), (1, 20, 1, 0.0)]
HIST_SHAPES = ([(96, 12000, half, 0.0) for half in (1, 2, 4, 8, 16)] + [(96, 12000, 16, 0.46)]
               + [(24, 12000, half, 0.0) for half in (32, 64, 128, 256)] + [(25, 12500, 16, 0.0)]
               + [(6, 12000, half, 0.46) for half in (1, 16, 256)] + E2E_FIT_SHAPES)
HIST_SWEEP_SHAPE = (96, 12000, 16, 0.0)  # the grid search's depth <= 6 chunks, deepest level


def phase_hist(torch, dev):
    from ae_waveforms_tpu_torch.ops.gbt_hist import (
        active_clusters, fixed_point_shift, hist_plan, left_histograms, left_histograms_fixed,
        left_histograms_fixed_reference, left_histograms_reference, pack_bins,
    )

    from ae_waveforms_tpu_torch.ops import gbt_hist

    # the plan's mirror of the kernel's shared-memory layout
    kernel_cells = _build.load("gbt_hist").gbt_hist_max_cells()
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
        before = dict(_build.launches)
        try:
            result = cli.main(["ppv", "--data", d, "--vectorized", "--gs_candidates", str(n_candidates),
                               "--seeds", str(n_seeds)])
        finally:
            cli.grid_search_cv, cli.ppv_analysis = originals
        launches = {k: v for k, v in launched(before).items() if k != "lstm_encoder"}
    print(f"[classify] launches during the classify run: {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched on the classify path: {launches}")
    check(launches["gbt_route"] == launches["gbt_hist"] + 1,
          f"a fit level routes in one launch and the PPV prediction in one: {launches}")
    check(launches["gbt_split"] == launches["gbt_hist"], f"a fit level splits in one launch: {launches}")
    check(launches["gbt_grad"] == launches["gbt_leaves"] < launches["gbt_hist"],
          f"a fit tree starts and ends in one launch each: {launches}")
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
    from ae_waveforms_tpu_torch.ops.gbt_tree import ROW_STREAM, subsample_uniforms

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

    before = dict(_build.launches)
    a, b = fit(dev), fit(dev)
    split_launches = launched(before)["gbt_split"]
    c = fit("cpu")
    torch.cuda.synchronize()
    print(f"[determinism] split kernel launches in the two card fits: {split_launches} ({trees} trees x depth "
          f"{depth} each)")
    check(split_launches == 2 * trees * depth, f"the split kernel ran {split_launches} times, not once a level")
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
            w = weights[s] * (subsample_uniforms(torch.tensor([s]), t, n, ROW_STREAM)[0].numpy() < 0.8)
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


# phase 8: the default model at full width, its data cut to 16,384 beats
TRAIN_BEATS, TRAIN_CASES = 16384, 128
TRAIN_ARGS = ["--epochs", "2", "--validation_interval", "25", "--split_size_val", "0.05", "--split_size_test", "0.05",
              "--plotting", ""]
# calls of train_step profiled, 20 inside the third chunk and 20 inside the fourth (no validation between):
# the first window traces CPU ops and kernels (the groups), the second kernels alone (the idle share)
PROFILE_STEPS = (28, 48)
IDLE_STEPS = (53, 73)
# a train step's gradients on the card against the CPU's, each leaf's largest difference over its largest |g|:
# a backward in full float32 holds it, one in TF32 (cuDNN's RNN backward outside cudnn_fp32) misses it
GRAD_RTOL = 1e-4


def write_beat_dir(d: str, n: int, cases: int, seed: int) -> None:
    """np_waves.npy, np_features.npy (the beats' fiducials, from a generator
    of their own, so the beats are those of ``synthetic_beats``) and
    np_info.npy: n synthetic beats, n / cases a case id."""
    from ae_waveforms_tpu_torch.core.schema import ArraySet, save_arrays

    info = np.stack([np.repeat(np.arange(cases) + 1000, n // cases), np.arange(n)], 1).astype(np.float64)
    waves, centres = synthetic_beats_and_centres(np.random.default_rng(seed), n)
    save_arrays(ArraySet(waves, beat_fiducials(waves, centres, np.random.default_rng(seed + 1)), info), d)


# the groups of a train step's device time: a kernel goes to the first group whose key's parts all appear in the
# name of its CPU op or, failing that, of the nearest ancestor that has one
LSTM_GROUPS = {"cuDNN LSTM backward": ("_cudnn_rnn_backward",), "cuDNN LSTM forward": ("_cudnn_rnn",),
               "optimizer": ("Optimizer.step",), "gather and loss": ("gather and loss",)}
CONV_GROUPS = {"optimizer": ("Optimizer.step",), "gather and loss": ("gather and loss",), "dropout": ("dropout",),
               "upsample": ("upsample",), "upsample backward": ("IndexSelectBackward",),
               "conv backward": ("onvolution", "ackward"), "conv forward": ("onvolution",)}


@contextlib.contextmanager
def workdir(work=None):
    """``work`` as it is, or a temporary directory under build/, removed after."""
    if work is not None:
        yield work
        return
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        yield tmp


def train_breakdown(torch, tag: str, groups, prof, idle_prof, steps: int, idle_wall_ms: float,
                    traced_host_ms: float) -> None:
    """Device ms per train step by group (``groups``; ``prof`` traced CPU
    ops and kernels), and the optimizer's host ms per step beside the
    step's (``traced_host_ms``, in the same window); the idle share from
    ``idle_prof``, which traced kernels alone over ``steps`` other steps of
    ``idle_wall_ms``, as serve_breakdown does (tracing CPU ops slows the
    host).  With ``groups`` None (steps replayed from a captured graph,
    whose kernels torch.profiler links to no op) the idle share alone."""
    busy = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in idle_prof.key_averages()) / steps / 1e3
    idle = (f"{steps} steps with kernels alone traced: device busy {busy:.4f} of {idle_wall_ms / steps:.4f} ms wall "
            f"per step, idle share {1 - busy * steps / idle_wall_ms:.3f}")
    if groups is None:
        print(f"[{tag}] device time by group not measured (the steps replay a captured graph); {idle}")
        return
    per = dict.fromkeys([*groups, "other"], 0.0)
    for e in prof.events():
        us = sum(k.duration for k in getattr(e, "kernels", []))
        name, a = None, e
        while us and name is None and a is not None:
            name = next((g for g, keys in groups.items() if all(k in a.name for k in keys)), None)
            a = a.cpu_parent
        if us:
            per[name or "other"] += us / steps / 1e3
    if sum(per.values()) == 0 or busy == 0:
        print(f"[{tag}] breakdown not measured: torch.profiler linked no kernel to an op or recorded none")
        return
    opt_host = sum(e.cpu_time_total for e in prof.events() if e.name.startswith("Optimizer.step")) / steps / 1e3
    print(f"[{tag}] {steps} steps profiled, device ms per step: " + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
          + f" (sum {sum(per.values()):.4f}); host ms per step with CPU ops traced: the optimizer's step "
          f"{opt_host:.4f} of {traced_host_ms:.4f}; {steps} more {idle}")


def instrumented_train(torch, args):
    """``cli.main_ae -m train`` with ``args``, each train step timed by
    CUDA events and by the host's clock, two windows of steps profiled
    (PROFILE_STEPS, IDLE_STEPS), each validation timed with the encoder
    kernel's launches counted.  Returns the run's records."""
    from torch.profiler import ProfilerActivity, profile

    from ae_waveforms_tpu_torch.cli import main_ae
    from ae_waveforms_tpu_torch.train import loop

    steps, host_ms, validations, prof = [], [], [], {}
    orig_step, orig_validate = loop.train_step, loop.validate

    def timed_step(*a, **k):
        for window, activities in ((PROFILE_STEPS, [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                                   (IDLE_STEPS, [ProfilerActivity.CUDA])):
            if len(steps) in window:
                torch.cuda.synchronize()
                if len(steps) == window[0]:
                    prof[window] = profile(activities=activities)
                    prof[window].start()
                    prof[window, "t0"] = time.perf_counter()
                else:
                    prof[window, "ms"] = (time.perf_counter() - prof[window, "t0"]) * 1e3
                    prof[window].stop()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t_host = time.perf_counter()
        loss = orig_step(*a, **k)
        host_ms.append((time.perf_counter() - t_host) * 1e3)
        end.record()
        steps.append((start, end, loss, a[4]))
        return loss

    def timed_validate(model, val_x, idx, mask, *a):
        torch.cuda.synchronize()
        before, t0 = dict(_build.launches), time.perf_counter()
        out = orig_validate(model, val_x, idx, mask, *a)
        validations.append(((time.perf_counter() - t0) * 1e3, launched(before)["lstm_encoder"], len(idx)))
        return out

    loop.train_step, loop.validate = timed_step, timed_validate
    before = dict(_build.launches)
    graphed = orig_step.captures, orig_step.replays
    try:
        t0 = time.perf_counter()
        run_dir = main_ae.autoencoder(["-m", "train", *args])
        train_s = time.perf_counter() - t0
    finally:
        loop.train_step, loop.validate = orig_step, orig_validate
    return dict(run_dir=run_dir, train_s=train_s, steps=steps, host_ms=host_ms, validations=validations, prof=prof,
                launches=launched(before)["lstm_encoder"], captures=orig_step.captures - graphed[0],
                replays=orig_step.replays - graphed[1])


def training_readings(torch, tag: str, rec, model_class: str, groups, batch: int):
    """Prints a run's ms per train step (p50 of the steps after the first
    10, outside the profiled windows), beats/s, the host's time to issue a
    step, ms per validation and the device split by ``groups``; checks that
    every loss is finite, the validation loss fell and every weight moved.
    Returns the validation CSV's rows."""
    from ae_waveforms_tpu_torch.models.registry import model_def
    from ae_waveforms_tpu_torch.train.checkpoint import load_state

    torch.cuda.synchronize()
    steps, host_ms, validations, prof = rec["steps"], np.array(rec["host_ms"]), rec["validations"], rec["prof"]
    step_ms = np.array([s.elapsed_time(e) for s, e, _, _ in steps])
    losses = torch.stack([loss for _, _, loss, _ in steps]).cpu().numpy()
    beats = torch.stack([mask for _, _, _, mask in steps]).sum(1).cpu().numpy()
    with open(os.path.join(rec["run_dir"], "training_log_validation.csv")) as f:
        val_rows = [[float(v) for v in row.split(",")] for row in f if row.strip()]
    val_losses = np.array([r[4] for r in val_rows])
    # the steps after the first 10, outside the profiled windows (tracing slows the host)
    timed = np.array([i >= 10 and not any(w[0] <= i < w[1] for w in (PROFILE_STEPS, IDLE_STEPS))
                      for i in range(len(steps))])
    p50 = rec["p50"] = float(np.median(step_ms[timed]))
    val_ms = np.array([v[0] for v in validations])
    print(f"[{tag}] {len(steps)} steps of B={batch} in {rec['train_s']:.2f} s wall (the CLI, data load and "
          f"checkpoints included); over the {int(timed.sum())} steps after the first 10 outside the profiled windows "
          f"(CUDA events): ms per train step p50 {p50:.4f}, min {step_ms[timed].min():.4f}, max "
          f"{step_ms[timed].max():.4f}; {beats[timed].sum() / step_ms[timed].sum() * 1e3:.1f} beats/s (their "
          f"{int(beats[timed].sum())} beats over their summed time; {batch / p50 * 1e3:.1f} at the p50; p50 with "
          f"the profiled steps in {float(np.median(step_ms[10:])):.4f}); host ms "
          f"to issue a step min {np.min(host_ms[timed]):.4f}, p50 {np.median(host_ms[timed]):.4f} "
          f"(the host waits where the card's queue is full)")
    print(f"[{tag}] step graph: {rec['captures']} capture, {rec['replays']} of {len(steps)} steps replayed")
    check(rec["captures"] == 1 and rec["replays"] == len(steps) - 1,
          f"the step graph captured {rec['captures']} times and replayed {rec['replays']} of {len(steps)} steps")
    print(f"[{tag}] MFU at the p50 step: {mfu_of(torch, train_flops(model_class) * batch, p50):.5f} of the card's "
          f"float32 peak (core/flops.py: {train_flops(model_class) * batch / 1e9:.3f} GFLOP a step of B={batch})")
    print(f"[{tag}] {len(validations)} validations of {validations[0][2]} batches: ms per validation p50 "
          f"{float(np.median(val_ms)):.3f} (wall, synchronised); validation loss {val_losses[0]:.6f} -> "
          f"{val_losses[-1]:.6f}")
    if (IDLE_STEPS, "ms") in prof:
        train_breakdown(torch, tag, None if rec["replays"] else groups, prof[PROFILE_STEPS], prof[IDLE_STEPS],
                        IDLE_STEPS[1] - IDLE_STEPS[0], prof[IDLE_STEPS, "ms"],
                        float(np.mean(host_ms[PROFILE_STEPS[0]:PROFILE_STEPS[1]])))

    check(bool(np.all(np.isfinite(losses))) and bool(np.all(np.isfinite(val_losses))), "a training loss is not finite")
    check(val_losses[-1] < val_losses[0], f"the validation loss did not fall: {val_losses[0]} -> {val_losses[-1]}")
    template = model_def(model_class).build(10, device="cpu").jax_tree()
    init = load_state(os.path.join(rec["run_dir"], "model_init.npz"), template)
    final = load_state(os.path.join(rec["run_dir"], "model_autoencoder.npz"), template)
    same = [f"{layer}.{k}" for layer in init for k in init[layer] if np.array_equal(init[layer][k], final[layer][k])]
    check(not same, f"weights that did not move from their init: {same}")
    return val_rows


def ten_steps(torch, work: str, init, device: str, make_optimizer=None, model_class: str = "LSTMAutoencoder"):
    """The per-step losses and the validation losses of 10 steps at B=32,
    dropout 0, from ``init``, validating after steps 0 and 9, on a data dir
    of its own (so each run draws the same split and batch order); with
    the trainer's ``make_optimizer`` replaced when one is given."""
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.train import loop

    data = os.path.join(work, "data")
    write_beat_dir(data, 1024, 32, seed=12)
    losses, orig, orig_make = [], loop.train_step, loop.make_optimizer

    def kept_step(*a, **k):
        losses.append(orig(*a, **k))
        return losses[-1]

    loop.train_step, loop.make_optimizer = kept_step, make_optimizer or orig_make
    try:
        cfg = TrainConfig(dataset_dir=data, results_dir=os.path.join(work, "results"), batch_size=32,
                          validation_interval=9, dropout=0.0, split_size_val=0.1, split_size_test=0.1, plotting=False,
                          model_class=model_class)
        run = loop.main_train(cfg, max_steps=10, device=device, init_params=init)
    finally:
        loop.train_step, loop.make_optimizer = orig, orig_make
    with open(os.path.join(run, "training_log_validation.csv")) as f:
        val = [float(row.split(",")[4]) for row in f if row.strip()]
    return np.array([float(v) for v in torch.stack(losses).cpu()] + val, np.float64)


def step_gradients(torch, device: str, x, fp32_backward: bool = True, model_class: str = "LSTMAutoencoder",
                   fp32_forward: bool = True):
    """Each parameter's gradient (float64, on the CPU) after one train step
    of ``model_class`` from seed 5's init on the batch ``x``, dropout 0.
    With ``fp32_backward`` False the same loss's backward runs outside
    ``cudnn_fp32``, under the process's TF32 flags, and with
    ``fp32_forward`` False the model's forward too (its module's
    ``cudnn_fp32`` made a no-op): the controls that show the check can see
    a step in TF32."""
    from ae_waveforms_tpu_torch.models.registry import model_def
    from ae_waveforms_tpu_torch.train.loop import batch_loss, train_step

    model = model_def(model_class).build(10, generator=torch.Generator().manual_seed(5), device=device).train()
    x = x.to(device)
    idx, mask = torch.arange(len(x), device=device), torch.ones(len(x), dtype=torch.bool, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    if fp32_backward:  # the trainer's own step, at learning rate 0
        train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), x, idx, mask, 0.0, generator, 0.0, "mse")
    else:
        module = sys.modules[type(model).__module__]
        guard = module.cudnn_fp32
        module.cudnn_fp32 = guard if fp32_forward else contextlib.nullcontext
        try:
            batch_loss(model, x, idx, mask, generator, 0.0, "mse").backward()
        finally:
            module.cudnn_fp32 = guard
    return {name: p.grad.double().cpu() for name, p in model.named_parameters()}


def grad_err(got, ref) -> float:
    """The largest over leaves of max |got - ref| / max |ref|."""
    return max(float((got[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref)


def phase_train_gradients(torch, model_class: str = "LSTMAutoencoder", tag: str = "train") -> None:
    """With both TF32 flags on, one step's gradients at B=32 on the card
    against the CPU's: the trainer's step within GRAD_RTOL of each leaf's
    largest, the control outside it (the LSTM's backward in TF32; the conv
    autoencoder's forward and backward in TF32)."""
    from ae_waveforms_tpu_torch.models.registry import model_def

    conv = model_def(model_class).channel_first
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    shape = (32, 1, T_BEAT) if conv else (32, T_BEAT, 1)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(shape).astype(np.float32))
    try:
        for f in flags:
            f.allow_tf32 = True
        ref = step_gradients(torch, "cpu", x, model_class=model_class)
        card = grad_err(step_gradients(torch, "cuda:0", x, model_class=model_class), ref)
        control = grad_err(step_gradients(torch, "cuda:0", x, False, model_class, fp32_forward=not conv), ref)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    print(f"[{tag}] one step's gradients at B=32, both TF32 flags on, against the CPU's (largest over leaves of "
          f"max |diff| / max |g|): the trainer's step {card:.3e}, its {'forward and ' if conv else ''}backward in "
          f"TF32 {control:.3e} (tolerance {GRAD_RTOL:g}, which the second must miss)")
    check(card <= GRAD_RTOL, f"the card's gradients part from the CPU's by {card}")
    check(control > GRAD_RTOL, f"a step in TF32 gave {control}: the gradient check cannot see TF32")


def adam_host_ms(torch, dev, reps: int = 50):
    """Host ms per ``step()`` of the port's Adam (optax's order) and of
    ``torch.optim.Adam(fused=True)`` on the default model's 26 tensors: the
    median of 5 bursts of ``reps`` steps after a warm one, the card
    synchronised between bursts."""
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.train.optimizers import make_optimizer

    params = list(LSTMAutoencoder(device=dev).parameters())
    for p in params:
        p.grad = torch.randn_like(p) * 1e-3
    out = {}
    for name, opt in (("port", make_optimizer("adam", params, 1e-3)),
                      ("fused", torch.optim.Adam(params, 1e-3, fused=True))):
        bursts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                opt.step()
            bursts.append((time.perf_counter() - t0) / reps * 1e3)
        out[name] = float(np.median(bursts[1:]))
    return out


def check_test_pass(torch, tag: str, args, run: str, model_class: str):
    """``cli.main_ae -m test`` of ``run`` on the card, timed, and the CPU's
    ``main_test`` on the same run: latents within 2e-5, reconstructions
    within 1e-4.  Returns the number of test beats and the encoder kernel's
    launches."""
    from ae_waveforms_tpu_torch.cli import main_ae
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.train.eval import main_test

    data, results = args[args.index("--dataset_dir") + 1], args[args.index("--results_dir") + 1]
    before = dict(_build.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main_ae.autoencoder(["-m", "test", "--trained_model", run, *args])
    test_ms = (time.perf_counter() - t0) * 1e3
    launches = launched(before)["lstm_encoder"]
    test_dir = os.path.join(results, "test_autoencoder", run)
    card_z = np.load(os.path.join(test_dir, "np_latent_spaces.npy"))
    card_pred = np.load(os.path.join(test_dir, "np_waves_test_pred.npy"))
    cfg = TrainConfig(model_class=model_class)
    cpu_out = main_test(cfg.replace(dataset_dir=data, results_dir=results, trained_model=run, plotting=False),
                        device="cpu")
    n_test = len(card_z)
    print(f"[{tag}] {n_test} beats in {-(-n_test // cfg.batch_size)} batches: {test_ms:.3f} ms wall (the CLI, data "
          f"load included), {n_test / test_ms * 1e3:.1f} latents/s")
    z_err = float(np.abs(card_z - cpu_out[3]).max())
    pred_err = float(np.abs(card_pred - cpu_out[2][0]).max())
    print(f"[{tag}] card against the CPU main_test on the same run: latents {z_err:.3e} (tolerance 2e-5), "
          f"reconstruction {pred_err:.3e} (tolerance 1e-4)")
    check(card_z.shape == (n_test, cfg.latent_size) and card_pred.shape == (n_test, T_BEAT), "test output shapes")
    check(z_err <= LATENT_ATOL and pred_err <= 1e-4, f"card and CPU test passes disagree: {z_err}, {pred_err}")
    return n_test, launches


def trajectories(torch, tag: str, work: str, model_class: str, init):
    """10 steps at B=32 from ``init``, twice on the card and once on the
    CPU: within 1e-5 relative of each other, and rtol 5e-4, atol 5e-5 of
    the CPU.  Returns the three runs' losses."""
    card_a, card_b, cpu10 = (ten_steps(torch, os.path.join(work, name), init, device, model_class=model_class)
                             for name, device in (("a", "cuda:0"), ("b", "cuda:0"), ("c", "cpu")))
    repeat = float(np.max(np.abs(card_a - card_b) / np.abs(card_b)))
    cpu_err = np.abs(card_a - cpu10)
    print(f"[{tag}] 10 steps at B=32 from one init, dropout 0 (10 train losses, 2 validation losses): two card runs "
          f"differ by {repeat:.3e} relative at most (bit-identical: {bool(np.array_equal(card_a, card_b))}); card "
          f"against CPU max_abs_err {cpu_err.max():.3e}, max relative {float(np.max(cpu_err / np.abs(cpu10))):.3e} "
          f"(tolerance rtol 5e-4, atol 5e-5)")
    check(repeat < 1e-5, f"two card runs of the same 10 steps differ by {repeat} relative")
    check(bool(np.all(cpu_err <= 5e-5 + 5e-4 * np.abs(cpu10))), "card and CPU training trajectories differ")
    return card_a, card_b, cpu10


def phase_train(torch, dev, work=None):
    """Phase 8; returns the encoder kernel's launches on its main path and,
    for phase 9, its data dir, results dir and run (in ``work``, which
    outlives the phase when the caller gives it)."""
    from ae_waveforms_tpu_torch.bridge import lstm_ae_params_to_numpy
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder

    cfg = TrainConfig()
    with workdir(work) as work:
        data, results = os.path.join(work, "data"), os.path.join(work, "results")
        write_beat_dir(data, TRAIN_BEATS, TRAIN_CASES, seed=10)
        args = ["--dataset_dir", data, "--results_dir", results, *TRAIN_ARGS]
        rec = instrumented_train(torch, args)
        run = os.path.basename(rec["run_dir"])
        val_rows = training_readings(torch, "train", rec, cfg.model_class, LSTM_GROUPS, cfg.batch_size)
        validations = rec["validations"]
        n_test, test_launches = check_test_pass(torch, "test", args, run, cfg.model_class)
        launches = {"train": rec["launches"], "test": test_launches}
        expected = {"train": sum(v[2] for v in validations), "test": -(-n_test // cfg.batch_size)}
        print(f"[train] lstm_encoder launches: {launches} (one per validation batch and test batch: {expected})")
        check(len(validations) == len(val_rows) and launches == expected, f"lstm_encoder launches {launches}, "
              f"expected {expected}")

        # the same 10 steps from one init, twice on the card and once on the CPU
        init10 = lstm_ae_params_to_numpy(LSTMAutoencoder(generator=torch.Generator().manual_seed(11), device="cpu"))
        _, _, cpu10 = trajectories(torch, "train", work, cfg.model_class, init10)
        # the trade of torch's fused Adam: its 10 steps on the card against the port's Adam on the CPU
        fused10 = ten_steps(torch, os.path.join(work, "d"), init10, "cuda:0",
                            lambda name, params, lr, *a, **k: torch.optim.Adam(params, lr, fused=True))
    phase_train_gradients(torch)
    adam_ms = adam_host_ms(torch, dev)
    fused_err = float(np.max(np.abs(fused10 - cpu10) / np.abs(cpu10)))
    print(f"[train] Adam, host ms per step on the default model: the port's (optax's order) {adam_ms['port']:.4f}, "
          f"torch.optim.Adam(fused=True) {adam_ms['fused']:.4f}; the fused one's 10 steps on the card against the "
          f"port's on the CPU: max relative {fused_err:.3e}")
    return launches["train"] + launches["test"], dict(data=data, results=results, run=run, step_ms=rec["p50"])


# phase 9: the conv autoencoder trained and tested on phase 8's data, then the reconstruction study
CONV = "LeNet5AutoencoderAvgPool"
SWEEP_CANDIDATES = 2000  # cli.analysis's --search_calls default
GBT_PARAMS = dict(max_depth=6, n_estimators=100, learning_rate=0.3)


def conv_scorer(torch, dev, results: str, run: str):
    """``Scorer.from_run`` of the conv run with phase 4's random GBT head,
    against the CPU ``Scorer`` (latents (n, 10) within 2e-5, reconstruction
    1e-4, probability 1e-5); prints the 64-beat p50.  Returns the routing
    kernel's launches in the scored run."""
    from ae_waveforms_tpu_torch.bridge import gbt_from_numpy
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.serve import Scorer

    cfg = TrainConfig(model_class=CONV)
    pool = synthetic_beats(np.random.default_rng(3), max(SIZES))
    gbt_arrays = random_gbt_arrays(np.random.default_rng(4))
    before = dict(_build.launches)
    scorer = Scorer.from_run(results, run, cfg, device=dev)
    scorer.warmup()
    edges = separated_edges(scorer.score(pool)["latents"], 64, margin=LATENT_ATOL)
    scorer.attach_gbt(gbt_from_numpy(**gbt_arrays, edges=edges, params=GBT_PARAMS, device=dev))
    card = {n: scorer.score(pool[:n]) for n in SIZES}
    launches = launched(before)["gbt_route"]
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        scorer.score(pool[:64])
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    print(f"[conv serve] launches of gbt_route during the scored run: {launches}; 64 beats (GBT head): p50 "
          f"{p50 * 1e3:.3f} ms, {64 / p50:.1f} beats/s")
    cpu = Scorer.from_run(results, run, cfg, device="cpu")
    cpu.attach_gbt(gbt_from_numpy(**gbt_arrays, edges=edges, params=GBT_PARAMS, device="cpu"))
    tolerances = {"latents": LATENT_ATOL, "reconstruction": 1e-4, "probability": 1e-5}
    for n in SIZES:
        g, c = card[n], cpu.score(pool[:n])
        check(sorted(g) == sorted(c), f"key sets differ: {sorted(g)} vs {sorted(c)}")
        check(g["latents"].shape == (n, cfg.latent_size) and g["reconstruction"].shape == (n, T_BEAT),
              f"conv Scorer shapes at {n} beats: {g['latents'].shape}, {g['reconstruction'].shape}")
        check(all(np.all(np.isfinite(v)) for v in g.values()), f"non-finite output at {n} beats")
        errs = {k: float(np.abs(g[k] - c[k]).max()) for k in tolerances}
        print(f"[conv serve] {n} beats vs CPU Scorer: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(all(v <= tolerances[k] for k, v in errs.items()), f"GPU and CPU Scorers disagree: {errs}")
    check(launches > 0, "the routing kernel was not launched by the conv Scorer")
    return launches


def reconstruction_study(torch, dev, data: str, results: str, runs):
    """``analysis.trad_vs_ae.compare`` on the card with the sigma sweep at
    SWEEP_CANDIDATES and ``runs`` (model_runs), timed by part; the card's
    objective against the CPU's on 64 candidates (rtol 1e-5 + atol 1e-7)
    and its final reconstruction against the CPU's (5e-5).  Returns the
    encoder kernel's launches in ``compare``."""
    from ae_waveforms_tpu_torch.analysis import trad_vs_ae
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.core.schema import load_arrays
    from ae_waveforms_tpu_torch.traditional.reconstruction import reconstruct_gaussian_batch
    from ae_waveforms_tpu_torch.traditional.sigma_search import make_objective, prepare_reconstruction_inputs
    from ae_waveforms_tpu_torch.train import eval as eval_mod

    for f in glob.glob(os.path.join(results, "networks_autoencoder", runs[0]["trained_model"], "indices_test_*.npy")):
        shutil.copy(f, data)
    arrays = load_arrays(data)
    t = {"objective_s": 0.0, "candidates": 0, "tests": []}
    orig = trad_vs_ae.make_objective, trad_vs_ae.sweep_search, trad_vs_ae.reconstruct_gaussian_batch, eval_mod.main_test

    def timed_make_objective(*a, **k):
        objective = orig[0](*a, **k)

        def timed(maps):
            t0 = time.perf_counter()
            out = objective(maps)  # numpy: the card has finished
            t["objective_s"] += time.perf_counter() - t0
            t["candidates"] += len(out)
            return out
        return timed

    def timed_sweep(*a, **k):
        t0 = time.perf_counter()
        t["best"] = orig[1](*a, **k)
        t["search_s"] = time.perf_counter() - t0
        return t["best"]

    def timed_recon(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig[2](*a, **k)
        torch.cuda.synchronize()
        t["recon_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def timed_test(cfg, *a, **k):
        torch.cuda.synchronize()
        before, t0 = dict(_build.launches), time.perf_counter()
        out = orig[3](cfg, *a, **k)
        t["tests"].append((cfg.model_class, (time.perf_counter() - t0) * 1e3, launched(before)["lstm_encoder"]))
        return out

    trad_vs_ae.make_objective, trad_vs_ae.sweep_search = timed_make_objective, timed_sweep
    trad_vs_ae.reconstruct_gaussian_batch, eval_mod.main_test = timed_recon, timed_test
    before = dict(_build.launches)
    try:
        t0 = time.perf_counter()
        out = trad_vs_ae.compare(TrainConfig(dataset_dir=data, results_dir=results, plotting=False), arrays=arrays,
                                 model_runs=runs, run_sigma_search=True, search_candidates=SWEEP_CANDIDATES,
                                 device=dev)
        wall_s = time.perf_counter() - t0
    finally:
        (trad_vs_ae.make_objective, trad_vs_ae.sweep_search, trad_vs_ae.reconstruct_gaussian_batch,
         eval_mod.main_test) = orig
    launches = launched(before)["lstm_encoder"]
    best_map, best = t["best"]
    print(f"[analysis] compare on the card: {wall_s:.3f} s wall; sigma sweep {t['search_s']:.3f} s wall, "
          f"{t['candidates']} candidates, {t['candidates'] / t['objective_s']:.1f} candidates/s over the objective's "
          f"{t['objective_s']:.3f} s; best map {best_map.tolist()} (objective {best:.6f}); final reconstruction "
          f"{t['recon_ms']:.3f} ms; test passes " + ", ".join(f"{m} {ms:.3f} ms ({k} lstm_encoder launches)"
                                                               for m, ms, k in t["tests"]))
    check(list(out) == ["traditional"] + [r["trained_model"] for r in runs], f"compare's methods {list(out)}")
    classes = {r["trained_model"]: r.get("model_class", "LSTMAutoencoder") for r in runs}
    for key, r in out.items():
        check(all(np.all(np.isfinite(v)) for v in (r.mse, r.rmse_per_sample, r.prd_per_sample, r.qs_per_sample)),
              f"{r.label}: a metric is not finite")
        print(f"[analysis] {r.label}{f' ({classes[key]})' if key in classes else ''}: MSE {r.mse:.6f}, median RMSE {r.rmse_median:.6f} (IQR "
              f"{np.percentile(r.rmse_per_sample, 25):.6f} to {np.percentile(r.rmse_per_sample, 75):.6f}), median "
              f"QS {r.qs_median:.6f}, n {len(r.rmse_per_sample)}")
    check(t["candidates"] >= SWEEP_CANDIDATES + 1 and bool(np.all((best_map >= 1) & (best_map <= 5))),
          f"the sweep scored {t['candidates']} candidates, best map {best_map}")
    check(launches == t["tests"][0][2] > 0, f"lstm_encoder launches in compare: {launches}")

    te = np.load(sorted(glob.glob(os.path.join(data, "indices_test_*.npy")))[0])
    beats = np.asarray(arrays.waves, np.float32)[te]
    fx, fy, bs, xt = prepare_reconstruction_inputs(np.asarray(arrays.features)[te])
    cands = np.random.default_rng(5).integers(1, 6, size=(64, 12)).astype(np.float32)
    card_obj, cpu_obj = (make_objective(fx, fy, bs, xt, beats - beats.max(1, keepdims=True), device=d)(cands)
                         for d in (dev, "cpu"))
    obj_err = float(np.max(np.abs(card_obj - cpu_obj) / (1e-7 + 1e-5 * np.abs(cpu_obj))))
    card_rec, cpu_rec = (reconstruct_gaussian_batch(fx, fy, xt, bs, best_map, device=d).cpu().numpy()
                         for d in (dev, "cpu"))
    rec_err = float(np.abs(card_rec - cpu_rec).max())
    print(f"[analysis] the card against the CPU: the objective on 64 candidates max |diff| / (1e-7 + 1e-5 |cpu|) "
          f"{obj_err:.3e} (at most 1), the final reconstruction of {len(beats)} beats max_abs_err {rec_err:.3e} "
          f"(tolerance 5e-5)")
    check(obj_err <= 1.0, "the card's objective parts from the CPU's")
    check(rec_err <= 5e-5, f"the card's reconstruction parts from the CPU's by {rec_err}")
    return launches


def phase_reconstruction(torch, dev, lstm=None):
    """Phase 9 on phase 8's data dir and LSTM run (``lstm``, as phase 8
    returns it; without one, a data dir and an LSTM run of its own through
    ``cli.main_ae``).  Returns the encoder and routing kernels' launches on
    its main paths."""
    from ae_waveforms_tpu_torch.bridge import conv_ae_params_to_numpy
    from ae_waveforms_tpu_torch.cli import analysis as cli_analysis
    from ae_waveforms_tpu_torch.cli import main_ae
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.models.conv_ae import LeNet5AutoencoderAvgPool

    batch = TrainConfig().batch_size
    with workdir(None if lstm is None else os.path.dirname(lstm["data"])) as work:
        if lstm is None:
            data, results = os.path.join(work, "data"), os.path.join(work, "results")
            write_beat_dir(data, TRAIN_BEATS, TRAIN_CASES, seed=10)
            run = main_ae.autoencoder(["-m", "train", "--dataset_dir", data, "--results_dir", results, *TRAIN_ARGS])
            lstm = dict(data=data, results=results, run=os.path.basename(run))
        data, results = lstm["data"], lstm["results"]
        args = ["--dataset_dir", data, "--results_dir", results, "--model_class", CONV, *TRAIN_ARGS]
        rec = instrumented_train(torch, args)
        conv_run = os.path.basename(rec["run_dir"])
        training_readings(torch, "conv train", rec, CONV, CONV_GROUPS, batch)
        check(rec["launches"] == 0, f"the conv trainer launched the LSTM encoder kernel {rec['launches']} times")
        check_test_pass(torch, "conv test", args, conv_run, CONV)
        init10 = conv_ae_params_to_numpy(LeNet5AutoencoderAvgPool(generator=torch.Generator().manual_seed(11),
                                                                  device="cpu"))
        trajectories(torch, "conv train", os.path.join(work, "conv10"), CONV, init10)
        phase_train_gradients(torch, CONV, "conv train")
        k2 = conv_scorer(torch, dev, results, conv_run)
        runs = [dict(trained_model=lstm["run"], latent_size=10),
                dict(trained_model=conv_run, latent_size=10, model_class=CONV)]
        k3 = reconstruction_study(torch, dev, data, results, runs)
        t0 = time.perf_counter()
        cli_analysis.main(["--dataset_dir", data, "--results_dir", results, "--search", "gp", "--search_calls", "200",
                           "--model", f"{lstm['run']}:10", "--device", str(dev)])
        print(f"[analysis] cli.analysis --search gp --search_calls 200 --model {lstm['run']}:10: "
              f"{time.perf_counter() - t0:.3f} s wall")
    return {"lstm_encoder": k3, "gbt_route": k2}


# phase 10: extraction from synthetic one-hour records to the three arrays, through both engines
EXTRACT_CASES, EXTRACT_S, EXTRACT_CHUNK = 24, 3600.0, 512
EXTRACT_STAGES = ("filter", "segment", "upload", "rpeaks", "qc", "median", "pull", "delineation", "features",
                  "write")
ARRAYS = ("waves", "features", "info")


def stage_times(stats) -> str:
    """A run's host wall seconds by stage and, for the device stages, device
    ms from CUDA events."""
    host = ", ".join(f"{k} {stats.host_s[k]:.3f}" for k in EXTRACT_STAGES if k in stats.host_s)
    device = ", ".join(f"{k} {stats.device_ms[k]:.3f}" for k in EXTRACT_STAGES if k in stats.device_ms)
    return f"host s by stage: {host}; device ms by stage (CUDA events): {device or 'none'}"


def traced_busy(torch, fn):
    """``fn`` run under torch.profiler tracing kernels alone: its wall
    seconds and the seconds in which at least one kernel or copy ran on the
    card (the union of their intervals: two streams may overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e6


def kernel_launches(torch, fn) -> int:
    """Kernels (and copies) that ``fn`` puts on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def fiducial_agreement(host, device, n_peaks):
    """(equal, compared) over the beats of each window: a fiducial agrees
    where both are NaN or both the same index."""
    equal = total = 0
    for k in host:
        valid = np.arange(host[k].shape[1])[None, :] < n_peaks[:, None]
        a, b = host[k][valid], device[k][valid]
        equal += int(((np.isnan(a) & np.isnan(b)) | (a == b)).sum())
        total += int(valid.sum())
    return equal, total


#: the goldens' feature tolerance on the card's machine: the reference's float64
#: filter is scipy's ba-form filtfilt, whose 4th-order 1 Hz high-pass is so
#: ill-conditioned that two scipy builds part by ~1e-8 on the golden record
#: (``filter_conditioning`` prints the ba form against the sos form), which
#: moves the features by ~5e-9; the CPU tests, with the scipy the goldens
#: were frozen with, hold 1e-9
GOLDEN_FEATURES_ATOL = 1e-7


def filter_conditioning() -> str:
    """The float64 ba-form filtfilt of the golden record's 1 Hz high-pass
    against the sos form of the same filter (equal in exact arithmetic)."""
    import scipy
    import scipy.signal

    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record
    from ae_waveforms_tpu_torch.signals.filters import zscore

    x = zscore(synthetic_ecg_record(duration_s=85.0, seed=1234))
    b, a = scipy.signal.butter(4, 1.0 / 250.0, "high")
    sos = scipy.signal.butter(4, 1.0 / 250.0, "high", output="sos")
    diff = float(np.abs(scipy.signal.filtfilt(b, a, x) - scipy.signal.sosfiltfilt(sos, x)).max())
    return f"scipy {scipy.__version__}: the golden record's float64 high-pass, ba form against sos form, {diff:.3e}"


def extraction_goldens(torch, dev) -> None:
    """The float64 host engine on the card reproduces the JAX package's
    frozen extraction (tests/goldens/extraction_golden.npz): waves within
    1e-6, windows and NaN patterns equal, features within
    ``GOLDEN_FEATURES_ATOL``; the device delineator reproduces its frozen
    fiducials."""
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES
    from ae_waveforms_tpu_torch.data.extract import extract_case
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record
    from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch

    z = np.load(ROOT / "tests" / "goldens" / "extraction_golden.npz")
    cfg = ExtractionConfig(precision="float64", delineation_engine="host")
    worst = {}
    for prefix, cid, rec in (("", 1, synthetic_ecg_record(duration_s=85.0, seed=1234)),
                             ("gap_", 2, synthetic_ecg_record(duration_s=85.0, seed=4321, nan_gaps=2))):
        got = extract_case(cid, rec, cfg, device=dev)
        want_f = z[prefix + "features"]
        check(got.waves.shape == z[prefix + "waves"].shape and np.array_equal(got.indices, z[prefix + "indices"]),
              f"golden {prefix or 'case'}: windows {got.indices} against {z[prefix + 'indices']}")
        check(np.array_equal(np.isnan(got.features), np.isnan(want_f)), f"golden {prefix or 'case'}: NaN pattern")
        worst[prefix or "case"] = (float(np.abs(got.waves - z[prefix + "waves"]).max()),
                                   float(np.nanmax(np.abs(got.features - want_f))))
        check(worst[prefix or "case"][0] <= 1e-6 and worst[prefix or "case"][1] <= GOLDEN_FEATURES_ATOL,
              f"golden {prefix or 'case'}: waves, features off by {worst[prefix or 'case']}")
    names = ["window"] + [f"patho_{m}_window" for m in ("absent_p", "biphasic_t", "fused_qrs", "tall_t")]
    plists = [z["peaks"]] + [z[n.replace("_window", "_peaks")] for n in names[1:]]
    peaks = np.full((len(names), 68), -1, np.int64)
    for i, p in enumerate(plists):
        peaks[i, : len(p)] = p
    n_peaks = np.array([len(p) for p in plists])
    fid = delineate_batch(torch.tensor(np.stack([z[n] for n in names]), dtype=torch.float32, device=dev),
                          torch.tensor(peaks, device=dev), torch.tensor(n_peaks, device=dev))
    for i, n in enumerate(names):
        for k in FIDUCIAL_NAMES:
            want = z[("fid_" if i == 0 else n.replace("_window", "_fid_")) + k]
            got = fid[k][i, : n_peaks[i]].cpu().numpy()
            check(np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(got[~np.isnan(got)],
                                                                                   want[~np.isnan(want)]),
                  f"the device delineator on golden {n}: {k} {got} against {want}")
    print(f"[extract] goldens on the card: the float64 host engine's case and gap case within (waves, features) "
          f"{worst} (limits 1e-6, {GOLDEN_FEATURES_ATOL}; {filter_conditioning()}), windows and NaN patterns equal; "
          f"the device delineator's fiducials on the {len(names)} golden windows equal the frozen ones")


def card_against_cpu(torch, dev, windows: np.ndarray) -> None:
    """Every device stage on the same windows on the card and on the CPU: R
    peaks, peak counts, the QC mask and the fiducials equal, the median
    beats within 1e-6 and the feature rows within 1e-5."""
    from ae_waveforms_tpu_torch.data.extract import K_LIGHT
    from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch
    from ae_waveforms_tpu_torch.signals.features_device import feature_rows_batch
    from ae_waveforms_tpu_torch.signals.median_beat import median_beat_batch
    from ae_waveforms_tpu_torch.signals.qc import qc_mask
    from ae_waveforms_tpu_torch.signals.rpeaks import LIGHT_CANDIDATES, find_rpeaks_batch

    def stages(device):
        x = torch.from_numpy(windows).to(device)
        peaks, n = find_rpeaks_batch(x, 500, candidate_slots=LIGHT_CANDIDATES)
        keep = qc_mask(x, peaks, n)
        pk = peaks[:, :K_LIGHT]
        med = median_beat_batch(x, pk, n)
        fid = delineate_batch(x, pk, n)
        rows = feature_rows_batch(x, pk, n, fid)
        return [t.cpu().numpy() for t in (peaks, n, keep, med, torch.stack(list(fid.values())), rows)]

    t0 = time.perf_counter()
    card = stages(dev)
    t1 = time.perf_counter()
    cpu = stages("cpu")
    t2 = time.perf_counter()
    for name, a, b in zip(("R peaks", "peak counts", "QC mask", "fiducials"), card[:3] + card[4:5], cpu[:3] + cpu[4:5]):
        same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a == b
        check(bool(same.all()), f"card against CPU: {name} differ on {int((~same).sum())} entries")
    med_err = float(np.nanmax(np.abs(card[3] - cpu[3])))
    row_err = float(np.nanmax(np.abs(card[5] - cpu[5])))
    nan_same = np.array_equal(np.isnan(card[3]), np.isnan(cpu[3])) and np.array_equal(np.isnan(card[5]),
                                                                                       np.isnan(cpu[5]))
    check(nan_same and med_err <= 1e-6 and row_err <= 1e-5,
          f"card against CPU: medians {med_err}, features {row_err}, NaN patterns equal {nan_same}")
    print(f"[extract] card against CPU on {len(windows)} windows of two cases (K = {K_LIGHT}): R peaks, peak counts, "
          f"QC mask ({int(card[2].sum())} kept) and {int((~np.isnan(card[4])).sum())} fiducials equal; medians within "
          f"{med_err:.3e} (limit 1e-6), features within {row_err:.3e} (limit 1e-5); wall s card {t1 - t0:.3f}, CPU "
          f"{t2 - t1:.3f}")


def delineator_parity(torch, dev, windows_by_case) -> None:
    """The device delineator against the C++ host one on every kept window
    of the host engine's cases, the same R peaks for both (PARITY.md's
    floors: exact >= 0.995)."""
    from ae_waveforms_tpu_torch.ops.native_delineate import delineate_batch_native
    from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch
    from ae_waveforms_tpu_torch.signals.qc import qc_mask
    from ae_waveforms_tpu_torch.signals.rpeaks import LIGHT_CANDIDATES, find_rpeaks_batch

    equal = total = windows = 0
    host_s = device_s = 0.0
    for w in windows_by_case:
        x = torch.from_numpy(w.astype(np.float32)).to(dev)
        peaks, n = find_rpeaks_batch(x, 500, candidate_slots=LIGHT_CANDIDATES)
        keep = qc_mask(x, peaks, n).cpu().numpy()
        peaks, n = peaks[keep], n[keep]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fid = {k: v.cpu().numpy() for k, v in delineate_batch(x[keep], peaks, n).items()}
        t1 = time.perf_counter()
        host = delineate_batch_native(w[keep], peaks.cpu().numpy(), n.cpu().numpy())
        t2 = time.perf_counter()
        e, t = fiducial_agreement(host, fid, n.cpu().numpy())
        equal, total, windows = equal + e, total + t, windows + int(keep.sum())
        host_s, device_s = host_s + t2 - t1, device_s + t1 - t0
    rate = equal / total
    print(f"[extract] device delineator against the C++ host one on all {windows} kept windows of the host engine's "
          f"cases, the same R peaks: {equal} of {total} fiducials exact ({rate:.5f}, floor 0.995); C++ "
          f"{host_s / windows * 1e3:.4f} ms per window ({os.cpu_count()} CPUs), device {device_s / windows * 1e3:.4f}")
    check(rate >= 0.995, f"device against host delineator: exact {rate:.5f} under the 0.995 floor")


def phase_extract(torch, dev, work=None):
    """Phase 10: extraction at the size of a real run, through both engines.
    Returns the three kernels' launches in it (none is on this path)."""
    from ae_waveforms_tpu_torch.cli import extract as cli_extract
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data import extract as ex
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    before = dict(_build.launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[extract] every figure of phase 10 is from {smi}")
    extraction_goldens(torch, dev)
    with workdir(work) as work:
        out = os.path.join(work, "extract")
        argv = ["--out", out, "--cases", str(EXTRACT_CASES), "--duration", str(int(EXTRACT_S))]

        # the host engine through the CLI's defaults (float64, engine host), then again from its cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        host = cli_extract.main(argv)
        host_s = time.perf_counter() - t0
        host_peak = torch.cuda.max_memory_allocated() / 2**20
        hs = host["stats"]
        n_host = sum(r.n_windows_raw for r in host["results"])
        written = {n: Path(out, f"np_{n}.npy").read_bytes() for n in ARRAYS}
        print(f"[extract] host engine: cli.extract {' '.join(argv[2:])} (float64, C++ delineator): {n_host} windows, "
              f"{sum(len(r.waves) for r in host['results'])} kept, in {host_s:.3f} s wall (record synthesis "
              f"included), {n_host / host_s:.1f} windows/s; {hs.passes} device passes (one a case), {hs.syncs} host "
              f"syncs; peak device memory {host_peak:.1f} MiB; {stage_times(hs)}")
        t0 = time.perf_counter()
        again = cli_extract.main(argv)
        again_s = time.perf_counter() - t0
        same = {n: Path(out, f"np_{n}.npy").read_bytes() == written[n] for n in ARRAYS}
        print(f"[extract] the same command again: {again_s:.3f} s wall, {again['stats'].passes} device passes, arrays "
              f"byte-identical {same}")
        check(all(same.values()) and again["stats"].passes == 0, f"the cached re-run: {same}, "
              f"{again['stats'].passes} passes")

        # the device engine over the same records and two more, made first (set-up, not timed with the run)
        t0 = time.perf_counter()
        records = {cid: synthetic_ecg_record(duration_s=EXTRACT_S, seed=cid) for cid in range(1, EXTRACT_CASES + 1)}
        records[EXTRACT_CASES + 1] = synthetic_ecg_record(duration_s=EXTRACT_S, seed=EXTRACT_CASES + 1, hr_bpm=160.0)
        records[EXTRACT_CASES + 2] = synthetic_ecg_record(duration_s=EXTRACT_S, seed=EXTRACT_CASES + 2, nan_gaps=3)
        synth_s = time.perf_counter() - t0
        ids = list(records)
        cfg = ExtractionConfig(precision="float32", delineation_engine="device", filter_backend="device")

        def device_run(stats):
            return ex.extract_cases(ids, records.__getitem__, cfg, batched=True, windows_per_batch=EXTRACT_CHUNK,
                                    device=dev, stats=stats)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ds = ex.ExtractionStats()
        t0 = time.perf_counter()
        dev_results = device_run(ds)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        ds.finish()
        dev_peak = torch.cuda.max_memory_allocated() / 2**20
        n_dev = sum(r.n_windows_raw for r in dev_results)
        chunks = ds.passes - ds.reruns
        print(f"[extract] device engine: extract_cases(batched, {EXTRACT_CHUNK} windows a chunk, float32, "
              f"filter_backend device) over {len(ids)} records ({synth_s:.3f} s to make them, not counted): {n_dev} "
              f"windows in {dev_s:.3f} s wall, {n_dev / dev_s:.1f} windows/s; {chunks} chunks, {ds.reruns} re-run at "
              f"the full width, {ds.syncs} host syncs ({ds.syncs / chunks:.3f} a chunk); peak device memory "
              f"{dev_peak:.1f} MiB; {stage_times(ds)}")
        check(ds.reruns >= 1, "no chunk was re-run at the full beat width")
        prof_s, busy = traced_busy(torch, lambda: device_run(None))
        print(f"[extract] device engine again under torch.profiler (kernels alone): {prof_s:.3f} s wall, the card "
              f"busy {busy:.3f} s, idle share {1 - busy / prof_s:.3f}")

        # one chunk's pass on its own: launches, device time, peak memory
        rec0 = ex.preprocess_record(records[1], cfg, dev)
        win = np.concatenate([ex._windows(rec0, cfg)[0]] * 3)[:EXTRACT_CHUNK].astype(np.float32)
        x = torch.from_numpy(win).to(dev)
        slots = ex._candidate_slots(win)
        launches = kernel_launches(torch, lambda: ex._window_pass(x, cfg, slots, ex.K_LIGHT, None, True))
        rpeak_launches = kernel_launches(torch, lambda: ex.find_rpeaks_batch(x, 500, candidate_slots=slots))
        torch.cuda.reset_peak_memory_stats()
        pass_ms = event_ms(torch, lambda: ex._window_pass(x, cfg, slots, ex.K_LIGHT, None, True), 3)
        pass_peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"[extract] one chunk pass of {EXTRACT_CHUNK} windows at K = {ex.K_LIGHT}: {launches} kernels and copies "
              f"({rpeak_launches} of them the R peaks', their acceptance loop 128 x 4), {pass_ms:.3f} ms (CUDA "
              f"events, launch gaps included), peak device memory {pass_peak:.1f} MiB")

        # the device engine against the host engine on every window
        host_by = {r.case_id: r for r in host["results"]}
        host_cfg = ExtractionConfig(precision="float64", delineation_engine="host")
        for cid in ids[EXTRACT_CASES:]:
            host_by[cid] = ex.extract_case(cid, records[cid], host_cfg, device=dev)
        wave_err, feat_rows = 0.0, 0
        for r in dev_results:
            h = host_by[r.case_id]
            check(np.array_equal(r.indices, h.indices), f"case {r.case_id}: the device engine keeps windows "
                  f"{sorted(set(r.indices) ^ set(h.indices))} that the host engine does not, or the reverse")
            wave_err = max(wave_err, float(np.abs(r.waves - h.waves).max(initial=0.0)))
            d = np.abs(r.features - h.features)
            feat_rows += int((np.nan_to_num(d) > 1e-3).any(axis=1).sum() + (np.isnan(r.features) != np.isnan(
                h.features)).any(axis=1).sum())
        kept = sum(len(r.waves) for r in dev_results)
        print(f"[extract] device engine against host engine on all {len(ids)} records: kept windows equal "
              f"({kept}), median beats within {wave_err:.3e} (limit 1e-5: the float32 device filter against scipy's "
              f"float64), {feat_rows} feature rows apart by more than 1e-3 or in their NaN pattern")
        check(wave_err <= 1e-5, f"device engine against host engine: median beats off by {wave_err}")

        windows_by_case = [ex._windows(ex.preprocess_record(records[cid], host_cfg), host_cfg)[0]
                           for cid in range(1, EXTRACT_CASES + 1)]
        delineator_parity(torch, dev, windows_by_case)
        card_against_cpu(torch, dev, np.concatenate(windows_by_case[:2]).astype(np.float32))
    counts = launched(before)
    counts = [counts[k] for k in ("lstm_encoder", "gbt_route", "gbt_hist")]
    print(f"[extract] lstm_encoder, gbt_route, gbt_hist launches in phase 10: {counts} (extraction reaches none)")
    return counts


# phase 11: many models at once, the DL classifier's size x seed sweep and multi-config AE training
DL_PER_CLASS, DL_BEATS_PER_CASE = 12000, 50
DL_SMALL, DL_BIG, DL_SEEDS, DL_EPOCHS = 500, 11500, 25, 2
# the main path without remat: the port trains one seed's working set at a time, so remat saves next to no memory
# and its 16 checkpointed chunks a layer cost several times the step (dl_compare measures both)
DL_ARGS = ["--sizes", str(DL_SMALL), str(DL_BIG), "--seeds", str(DL_SEEDS), "--epochs", str(DL_EPOCHS), "--vectorized",
           "--remat_chunk", "0"]
DL_COMPARE_SIZE = 1000  # stacked against one seed after another, and peak memory with and without remat
MULTI_ARGS = ["--epochs", "1", "--validation_interval", "25", "--split_size_val", "0.05", "--split_size_test",
              "0.05", "--plotting", ""]
MULTI_SEEDS, MULTI_LRS, MULTI_LATENTS = "0,1,2,3", "1,0.5", "10,20"
STEP_WINDOW = (10, 15)  # calls of a stacked step traced for the idle share
STACKED_GRAD_TOL = 1e-3  # the LSTM leaves' gradients on the card against float64 (stacked_tf32_check)


def write_dl_dir(d: str, seed: int) -> None:
    """np_waves.npy, np_info.npy, controls.csv and hypopotassium.csv:
    12,000 synthetic beats a class, 50 a case id; the sick class's T wave
    at 0.6 of its height (hypokalaemia flattens it)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    waves, centres = synthetic_beats_and_centres(rng, 2 * DL_PER_CLASS)
    t = np.arange(T_BEAT)[None, :]
    bump = 0.3 * np.exp(-0.5 * ((t - centres[DL_PER_CLASS:, 4:5]) / WAVE_WIDTHS[4]) ** 2)
    waves[DL_PER_CLASS:] -= (0.4 * bump).astype(np.float32)
    ids = np.repeat(np.arange(2 * DL_PER_CLASS // DL_BEATS_PER_CASE) + 5000, DL_BEATS_PER_CASE)
    np.save(os.path.join(d, "np_waves.npy"), waves)
    np.save(os.path.join(d, "np_info.npy"), np.stack([ids, np.arange(len(ids))], 1).astype(np.float64))
    for name, part in (("controls.csv", np.unique(ids[:DL_PER_CLASS])), ("hypopotassium.csv",
                                                                         np.unique(ids[DL_PER_CLASS:]))):
        with open(os.path.join(d, name), "w") as f:
            f.write("idx,caseid\n" + "".join(f"{i},{c}\n" for i, c in enumerate(part)))


class StepTimer:
    """``module.name`` (a stacked step) replaced inside the ``with``: each
    call timed by CUDA events with its count of active configs and its data
    tensor's shape, and calls [STEP_WINDOW) traced by torch.profiler
    (kernels alone) for the idle share."""

    def __init__(self, torch, module, name: str):
        self.torch, self.module, self.name = torch, module, name
        self.orig = getattr(module, name)
        self.calls, self.prof, self.window_s = [], None, None

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        if self.prof is not None and self.window_s is None:
            self.prof.stop()

    def __call__(self, stacked, optimizer, active, *a):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        i = len(self.calls)
        if i == STEP_WINDOW[0]:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.orig(stacked, optimizer, active, *a)
        end.record()
        self.calls.append((start, end, len(active), tuple(a[0].shape)))
        if i == STEP_WINDOW[1] - 1:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()
        return out

    def ms(self, keep=None):
        """CUDA-event ms of the calls outside the traced window (``keep``
        picks calls by index)."""
        self.torch.cuda.synchronize()
        return np.array([s.elapsed_time(e) for i, (s, e, _, _) in enumerate(self.calls)
                         if not STEP_WINDOW[0] <= i < STEP_WINDOW[1] and (keep is None or keep(i))])

    def idle_share(self) -> float:
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.prof.events()
                       if e.device_type == self.torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        return 1.0 - busy / 1e6 / self.window_s


def stacked_pair(torch, kind: str, device, dtype=None, seeds=(5, 6)):
    """Two configs of the LSTM autoencoder or the LSTM classifier stacked on
    ``device`` from the seeds' inits (in ``dtype``, float32 when None)."""
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
    from ae_waveforms_tpu_torch.train.stacked import StackedConfigs

    dtype = dtype or torch.float32
    cls = LSTMAutoencoder if kind == "ae" else LSTMClassifier
    models = [cls(generator=torch.Generator().manual_seed(s), device="cpu").to(dtype) for s in seeds]
    return StackedConfigs(cls(device=device).to(dtype).train(), models, device)


def stacked_gradients(torch, kind: str, device: str, fp32_backward: bool = True, dtype=None):
    """Both configs' gradients (float64, on the CPU) after one stacked step
    at B=32, dropout 0, learning rate 0, in ``dtype`` (float32 when None);
    with ``fp32_backward`` False the losses' backward runs outside
    ``cudnn_fp32``."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.train.loop import batch_loss
    from ae_waveforms_tpu_torch.train.multi import multi_step

    stacked = stacked_pair(torch, kind, device, dtype)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 32, T_BEAT, 1)).astype(np.float32)).to(device, dtype)
    y = torch.from_numpy((rng.random((2, 32)) > 0.5).astype(np.float32)).to(device, dtype)
    idx = torch.arange(32, device=device).expand(2, 32)
    mask = torch.ones((2, 32), dtype=torch.bool, device=device)
    gens = [torch.Generator(device=device).manual_seed(s) for s in (0, 1)]
    optimizer = torch.optim.SGD(stacked.param_groups(), lr=0.0)
    if fp32_backward and kind == "ae":
        multi_step(stacked, optimizer, [0, 1], x[0], idx, mask, [0.0, 0.0], gens, 0.0, "mse")
    elif fp32_backward:
        dl.stacked_step(stacked, optimizer, [0, 1], x, y, idx, mask, gens, 0.0, None)
    else:
        for s in (0, 1):
            loss = (batch_loss(stacked.bound(s), x[0], idx[s], mask[s], gens[s], 0.0, "mse") if kind == "ae"
                    else dl.batch_bce(stacked.bound(s), x[s], y[s], idx[s], mask[s], gens[s], 0.0, None))
            loss.backward()
    return {f"{s}.{k}": p.grad.double().cpu() for s, leaves in enumerate(stacked.leaves) for k, p in leaves.items()}


def lstm_grad_err(got, ref) -> float:
    """Relative error, in the Frobenius norm, of all the LSTM leaves'
    gradients together (every config's)."""
    keys = [k for k in ref if "lstm" in k or ".enc" in k or ".dec" in k]
    diff = sum(float((got[k] - ref[k]).square().sum()) for k in keys)
    return (diff / sum(float(ref[k].square().sum()) for k in keys)) ** 0.5


def stacked_tf32_check(torch, dev) -> None:
    """With both TF32 flags on, one step of each stacked trainer on the
    card, held to the same step in float64 on the CPU by the LSTM leaves'
    gradients (``lstm_grad_err``): within STACKED_GRAD_TOL and within a
    tenth of the same losses' error with their backward outside
    ``cudnn_fp32``, in TF32.  Not phase 8's 1e-4 of each leaf's largest: at
    init the classifier's gradients are ill-conditioned (BatchNorm divides
    by the small spread of 32 pooled rows, and the attention pooling's sums
    mostly cancel), so float32 alone, on the CPU, is 5.8e-5 from float64
    over its LSTM leaves and up to 1.5e-3 on a bias.  Also: no cuDNN
    warning that an LSTM's weights were copied (the flat copies are read in
    place)."""
    import warnings

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        for kind in ("ae", "classifier"):
            ref = stacked_gradients(torch, kind, "cpu", dtype=torch.float64)
            cpu = lstm_grad_err(stacked_gradients(torch, kind, "cpu"), ref)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                card = lstm_grad_err(stacked_gradients(torch, kind, dev), ref)
            copied = [w for w in caught if "contiguous chunk" in str(w.message)]
            tf32 = lstm_grad_err(stacked_gradients(torch, kind, dev, fp32_backward=False), ref)
            print(f"[many] {kind}: one stacked step of 2 configs at B=32, both TF32 flags on, the LSTM leaves' "
                  f"gradients against the float64 step on the CPU (relative, Frobenius): the card {card:.3e}, its "
                  f"backward in TF32 {tf32:.3e}, the CPU's float32 step {cpu:.3e} (the card within "
                  f"{STACKED_GRAD_TOL:g} and a tenth of TF32's); cuDNN weight-copy warnings {len(copied)}")
            check(card <= min(STACKED_GRAD_TOL, tf32 / 10), f"{kind} stacked gradients under TF32 flags: {card}, "
                  f"{tf32}")
            check(not copied, f"cuDNN copied the {kind}'s LSTM weights: {copied[0].message if copied else ''}")
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def working_set_probe(torch, dev) -> None:
    """Peak device memory of one training step of one config beside
    ``core/hbm.py``'s working-set count: the classifier at B=512 without and
    with remat 20, the LSTM autoencoder at B=128 (T=320, learning rate 0,
    the step run once before, so the peak is a warm step's); and of the
    classifier's eval-mode pass over 500 rows."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.core import hbm
    from ae_waveforms_tpu_torch.train.multi import multi_step

    rng = np.random.default_rng(7)
    for kind, B, remat in (("classifier", 512, None), ("classifier", 512, 20), ("ae", 128, None)):
        stacked = stacked_pair(torch, kind, dev, seeds=(5,))
        x = torch.from_numpy(rng.standard_normal((1, B, T_BEAT, 1)).astype(np.float32)).to(dev)
        y = torch.from_numpy((rng.random((1, B)) > 0.5).astype(np.float32)).to(dev)
        idx, mask = torch.arange(B, device=dev)[None], torch.ones((1, B), dtype=torch.bool, device=dev)
        gens = [torch.Generator(device=dev).manual_seed(0)]
        optimizer = torch.optim.SGD(stacked.param_groups(), lr=0.0)
        hidden = dl.HIDDEN_SIZES if kind == "classifier" else (128, 64, 10, 64, 128, 1)

        def step():
            if kind == "ae":
                multi_step(stacked, optimizer, [0], x[0], idx, mask, [0.0], gens, 0.2, "mse")
            else:
                dl.stacked_step(stacked, optimizer, [0], x, y, idx, mask, gens, 0.2, remat)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        model = hbm.recurrent_working_set_bytes(T_BEAT, B, hidden, remat or 0)
        print(f"[many] working set of one {kind} step at B={B}, T={T_BEAT}, remat {remat or 'off'}: peak device "
              f"memory over the step {peak / 2**20:.1f} MiB, core/hbm.py's count {model / 2**20:.1f} MiB "
              f"({peak / (4 * B * T_BEAT * sum(hidden)):.2f} float32 words a (row, step, unit))")
    # the classifier's eval-mode pass over 500 rows (the sweep's test set; its validation passes alike)
    model = stacked_pair(torch, "classifier", dev, seeds=(5,)).module_of(0).eval()
    x = torch.from_numpy(rng.standard_normal((500, T_BEAT, 1)).astype(np.float32)).to(dev)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model(x)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    count = hbm.recurrent_working_set_bytes(T_BEAT, 0, dl.HIDDEN_SIZES, 0, n_val=500)
    print(f"[many] working set of the classifier's eval-mode pass over 500 rows: peak device memory "
          f"{peak / 2**20:.1f} MiB, core/hbm.py's count {count / 2**20:.1f} MiB "
          f"({peak / (4 * 500 * T_BEAT * sum(dl.HIDDEN_SIZES)):.2f} float32 words a (row, step, unit))")


def dl_checks(torch, dev) -> None:
    """Two seeds from one init, dropout 0, on the card, once more on the
    card one at a time, and on the CPU: 2 epochs of 128 beats at B=64, the
    last epoch's params kept (min_delta -1); the models' probabilities on 64
    other beats."""
    from ae_waveforms_tpu_torch import bridge
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.models.lstm_classifier import LSTMClassifier
    from ae_waveforms_tpu_torch.train.checkpoint import tree_leaves

    rng = np.random.default_rng(21)
    beats = synthetic_beats(rng, 2 * 128 + 2 * 64 + 64)[:, :, None]
    Xs, Xvs, Xt = beats[:256].reshape(2, 128, T_BEAT, 1), beats[256:384].reshape(2, 64, T_BEAT, 1), beats[384:]
    ys = np.tile(np.r_[np.zeros(64), np.ones(64)], (2, 1))
    yvs = np.tile(np.r_[np.zeros(32), np.ones(32)], (2, 1))
    kw = dict(num_epochs=2, batch_size=64, min_delta=-1.0, dropout_rate=0.0)
    init = {s: bridge.classifier_to_numpy(LSTMClassifier(generator=torch.Generator().manual_seed(100 + s),
                                                         device="cpu")) for s in (0, 1)}

    def probs(models, device):
        out = []
        for params, state in models:
            model = bridge.classifier_from_numpy(params, state, device=device)
            with torch.no_grad():
                out.append(model(torch.from_numpy(Xt).to(device)).cpu().numpy())
        return np.stack(out)

    card = dl.train_classifier_multi(Xs, ys, Xvs, yvs, [0, 1], device=dev, init=init.__getitem__, **kw)
    single = [dl.train_classifier(Xs[i], ys[i], Xvs[i], yvs[i], i, device=dev, init=init.__getitem__, **kw)
              for i in (0, 1)]
    cpu = dl.train_classifier_multi(Xs, ys, Xvs, yvs, [0, 1], device="cpu", init=init.__getitem__, **kw)
    same = all(np.array_equal(a, b) for i in (0, 1) for a, b in zip(tree_leaves(card[i]), tree_leaves(single[i])))
    p_card, p_single, p_cpu = probs(card, dev), probs(single, dev), probs(cpu, "cpu")
    err = float(np.abs(p_card - p_cpu).max())
    print(f"[many] DL classifier, 2 seeds from one init, dropout 0, 4 steps at B=64: stacked against each seed "
          f"alone on the card bit-identical: {same} (probabilities {np.abs(p_card - p_single).max():.3e} apart); card "
          f"against CPU probabilities max_abs_err {err:.3e} (tolerance 1e-3: 4 Adam steps of lr 1e-4 move a weight "
          f"whose gradient is rounding noise by up to 4e-4)")
    check(float(np.abs(p_card - p_single).max()) <= 1e-6, "stacked seeds differ from single-seed runs on the card")
    check(err <= 1e-3, f"card and CPU DL training differ by {err}")


def dl_compare(torch, dev, control, sick, hbm_shape):
    """At DL_COMPARE_SIZE, one epoch of the 25 seeds: stacked (remat off and
    20) and one seed after another (remat off): wall s and peak memory
    beside ``core/hbm.py``'s count."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.core import hbm

    n_train = int(DL_COMPARE_SIZE * 2 * 0.8)
    n_val = 2 * DL_COMPARE_SIZE - n_train
    params = dl._param_count()
    out = {}
    for name, vectorized, remat in (("stacked, remat off", True, None), ("stacked, remat 20", True, 20),
                                    ("one seed after another, remat off", False, None)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dl.dl_size_seed_sweep(control, sick, sizes=(DL_COMPARE_SIZE,), n_seeds=DL_SEEDS, num_epochs=1,
                              vectorized=vectorized, remat_chunk=remat, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        S = DL_SEEDS if vectorized else 1
        model = (S * hbm.train_block_hbm_bytes_per_config(n_train, n_val, T_BEAT, 512, dl.HIDDEN_SIZES, params)
                 + hbm.recurrent_working_set_bytes(T_BEAT, 512, dl.HIDDEN_SIZES, remat or 0, n_val))
        out[name] = wall
        print(f"[many] DL, size {DL_COMPARE_SIZE} ({n_train} train rows), {DL_SEEDS} seeds, 1 epoch, {name}: "
              f"{wall:.3f} s wall, {DL_SEEDS / wall:.3f} model-epochs/s; peak device memory {peak / 2**20:.1f} MiB, "
              f"core/hbm.py's count {model / 2**20:.1f} MiB")
    cap = hbm.seed_axis_cap(*hbm_shape, dl.HIDDEN_SIZES, params)
    ratio = out["one seed after another, remat off"] / out["stacked, remat off"]
    print(f"[many] DL: one seed after another takes {ratio:.3f}x the stacked wall time; core/hbm.py's seed cap at "
          f"size {DL_BIG} ({hbm_shape[0]} train rows, no remat) on this card: {cap}")


def phase_dl(torch, dev, work):
    """The DL half of phase 11; its main path is ``cli.classify deep``."""
    from ae_waveforms_tpu_torch.classify import dl
    from ae_waveforms_tpu_torch.cli import classify as cli_classify

    data = os.path.join(work, "dl")
    write_dl_dir(data, seed=40)
    chunk_s, real_multi = [], dl.train_classifier_multi

    def timed_multi(Xs, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_multi(Xs, *a, **k)
        torch.cuda.synchronize()
        chunk_s.append((Xs.shape[1], time.perf_counter() - t0))
        return out

    dl.train_classifier_multi = timed_multi
    try:
        with StepTimer(torch, dl, "stacked_step") as steps:
            t0 = time.perf_counter()
            summary = cli_classify.main(["deep", "--data", data, *DL_ARGS])
            wall = time.perf_counter() - t0
    finally:
        dl.train_classifier_multi = real_multi
    n_big, big_s = next((n, s) for n, s in chunk_s if n == int(2 * DL_BIG * 0.8))
    ms = steps.ms(lambda i: steps.calls[i][2] == DL_SEEDS and steps.calls[i][3][1] == n_big)
    print(f"[many] cli.classify deep {' '.join(DL_ARGS)}: {wall:.3f} s wall; size {DL_BIG}: {DL_SEEDS} seeds x "
          f"{-(-n_big // 512)} steps an epoch, trained in {big_s:.3f} s, {DL_SEEDS * DL_EPOCHS / big_s:.3f} "
          f"model-epochs/s; ms per stacked step of {DL_SEEDS} seeds (CUDA events, {len(ms)} steps) p50 "
          f"{np.median(ms):.3f}, min {ms.min():.3f}, max {ms.max():.3f} ({np.median(ms) / DL_SEEDS:.3f} a seed); "
          f"idle share over steps {STEP_WINDOW[0]} to "
          f"{STEP_WINDOW[1] - 1} {steps.idle_share():.3f}")
    from ae_waveforms_tpu_torch.core import flops

    print(f"[many] DL stacked step of {DL_SEEDS} seeds at B=512: MFU at the p50 "
          f"{mfu_of(torch, DL_SEEDS * 512 * 3 * flops.dl_classifier_fwd_flops_per_sample(T_BEAT), np.median(ms)):.5f}"
          f" of the float32 peak")
    print(f"[many] DL sweep median AUC by size: " + ", ".join(f"{r['size']} {r['median_auc']:.4f} (IQR {r['q1']:.4f}-"
                                                              f"{r['q3']:.4f})" for r in summary))
    check([r["size"] for r in summary] == [DL_SMALL, DL_BIG], "DL sweep sizes")
    check(all(len(r["aucs"]) == DL_SEEDS and np.all(np.isfinite(r["aucs"])) for r in summary), "DL sweep AUCs")
    out = os.path.join(data, f"{DL_EPOCHS}_hypopotassium")
    check(os.path.isfile(os.path.join(out, "summary_auc_stats.csv")), "DL sweep summary CSV")
    check(len(ms) > 0, f"no stacked step of {DL_SEEDS} seeds was timed")

    waves = np.load(os.path.join(data, "np_waves.npy"))
    dl_compare(torch, dev, waves[:DL_PER_CLASS], waves[DL_PER_CLASS:], (n_big, 2 * DL_BIG - n_big, T_BEAT, 512))
    dl_checks(torch, dev)


def multi_readings(torch, tag: str, steps: StepTimer, S: int, wall: float, single_ms: float) -> None:
    ms = steps.ms(lambda i: steps.calls[i][2] == S)
    print(f"[many] {tag}: MFU at the p50 stacked step "
          f"{mfu_of(torch, S * 128 * train_flops('LSTMAutoencoder'), float(np.median(ms))):.5f} of the float32 peak")
    print(f"[many] {tag}: {len(steps.calls)} stacked steps of {S} configs in {wall:.3f} s wall (the CLI, data and "
          f"run dirs included); ms per stacked step (CUDA events) p50 {np.median(ms):.3f}, min {ms.min():.3f}, "
          f"max {ms.max():.3f}, beside {S} x phase 8's step {S * single_ms:.3f}; {S / np.median(ms) * 1e3:.1f} "
          f"configs x steps/s at the p50; idle share over steps {STEP_WINDOW[0]} to {STEP_WINDOW[1] - 1} "
          f"{steps.idle_share():.3f}")


def multi_checks(torch, dev, work: str) -> None:
    """On a 1,024-beat data dir at B=32, dropout 0: two configs together
    against each alone on the card, the card against the CPU from one init
    (10 steps, phase 8's tolerances), and a resume from the checkpoint
    after step 7 against the run it left."""
    from ae_waveforms_tpu_torch.bridge import lstm_ae_params_to_numpy
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.core.schema import load_arrays
    from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
    from ae_waveforms_tpu_torch.train.checkpoint import tree_leaves
    from ae_waveforms_tpu_torch.train.multi import stack_trees, train_ae_multi, unstack_tree

    data = os.path.join(work, "multi_data")
    write_beat_dir(data, 1024, 32, seed=12)
    arrays = load_arrays(data)
    cfg = TrainConfig(dataset_dir=data, results_dir=os.path.join(work, "multi_res"), batch_size=32,
                      validation_interval=3, dropout=0.0, split_size_val=0.1, split_size_test=0.1, plotting=False)
    init = stack_trees([lstm_ae_params_to_numpy(LSTMAutoencoder(generator=torch.Generator().manual_seed(s),
                                                                device="cpu")) for s in (11, 12)])
    # one segment a dispatch, so max_steps (checked after a dispatch) ends the runs after 10 and 7 steps
    kw = dict(arrays=arrays, lr_multipliers=[1.0, 0.5], max_steps=10, init_params=init, segments_per_dispatch=1)
    card = train_ae_multi(cfg, [0, 1], device=dev, **kw)
    cpu = train_ae_multi(cfg, [0, 1], device="cpu", **kw)
    ones = [train_ae_multi(cfg, [s], arrays=arrays, lr_multipliers=[m], max_steps=10, device=dev,
                           segments_per_dispatch=1, init_params=stack_trees([unstack_tree(init)[s]]))
            for s, m in ((0, 1.0), (1, 0.5))]
    got = np.concatenate([card.train_losses, card.val_losses])
    want = np.concatenate([cpu.train_losses, cpu.val_losses])
    alone = np.concatenate([np.concatenate([o.train_losses, o.val_losses]) for o in ones], 1)
    err = np.abs(got - want)
    print(f"[many] multi AE, 2 configs (lr x1, x0.5) from one init, dropout 0, {len(card.train_losses)} steps at "
          f"B=32 ({len(card.train_losses)} train and {len(card.val_losses)} validation losses each): together against "
          f"each alone on the card bit-identical: {bool(np.array_equal(got, alone))} (max relative "
          f"{float(np.max(np.abs(got - alone) / np.abs(alone))):.3e}); card against CPU max_abs_err {err.max():.3e}, "
          f"max relative {float(np.max(err / np.abs(want))):.3e} (tolerance rtol 5e-4, atol 5e-5)")
    check(bool(np.all(np.isfinite(got))), "multi AE losses are not finite")
    check(float(np.max(np.abs(got - alone) / np.abs(alone))) <= 1e-6, "configs together differ from each alone")
    check(bool(np.all(err <= 5e-5 + 5e-4 * np.abs(want))), "card and CPU multi-config training differ")

    ck = os.path.join(work, "multi_ck")
    full = train_ae_multi(cfg, [0, 1], device=dev, results_dir=os.path.join(work, "multi_full"), **kw)
    part = train_ae_multi(cfg, [0, 1], device=dev, results_dir=ck, checkpoint_every=1, **{**kw, "max_steps": 5})
    resumed = train_ae_multi(cfg, [0, 1], device=dev, results_dir=ck, checkpoint_every=1, resume_dir=ck, **kw)
    same = (np.array_equal(resumed.train_losses, full.train_losses)
            and np.array_equal(resumed.val_losses, full.val_losses)
            and all(np.array_equal(a, b) for a, b in zip(tree_leaves(resumed.best_params),
                                                         tree_leaves(full.best_params))))
    print(f"[many] multi AE resumed from its checkpoint after {len(part.train_losses)} of {len(full.train_losses)} "
          f"steps against the uninterrupted run: bit-identical {same}")
    check(same and len(part.train_losses) < len(full.train_losses), "a resumed multi-config run differs from the "
          "uninterrupted one")


def phase_multi(torch, dev, lstm):
    """The AE half of phase 11 on phase 8's data; its main path is
    ``cli.main_ae`` multi-config training and one run's test pass.
    Returns the encoder kernel's launches there."""
    from ae_waveforms_tpu_torch.cli import main_ae
    from ae_waveforms_tpu_torch.core import hbm
    from ae_waveforms_tpu_torch.core.config import TrainConfig
    from ae_waveforms_tpu_torch.train import multi

    cfg = TrainConfig()
    base = ["--dataset_dir", lstm["data"], "--results_dir", os.path.join(os.path.dirname(lstm["data"]), "multi"),
            *MULTI_ARGS]
    S = len(MULTI_SEEDS.split(",")) * len(MULTI_LRS.split(","))
    before = dict(_build.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with StepTimer(torch, multi, "multi_step") as steps:
        t0 = time.perf_counter()
        runs = main_ae.autoencoder(["-m", "train", *base, "--seeds", MULTI_SEEDS, "--lr_sweep", MULTI_LRS])
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    with StepTimer(torch, multi, "multi_step") as steps2:
        t0 = time.perf_counter()
        grouped = main_ae.autoencoder(["-m", "train", *base, "--latent_sizes", MULTI_LATENTS])
        wall2 = time.perf_counter() - t0
    test = main_ae.autoencoder(["-m", "test", *base, "--trained_model", os.path.basename(runs[0])])
    launches = launched(before)["lstm_encoder"]
    multi_readings(torch, f"cli.main_ae --seeds {MULTI_SEEDS} --lr_sweep {MULTI_LRS}", steps, S, wall,
                   lstm["step_ms"])
    multi_readings(torch, f"cli.main_ae --latent_sizes {MULTI_LATENTS}", steps2, 1, wall2, lstm["step_ms"])
    n_rows = sum(int(np.load(glob.glob(os.path.join(runs[0], f"indices_{split}_*.npy"))[0]).sum())
                 for split in ("train", "val"))  # the rows on the card, held once for every config
    p_count = sum(p.numel() for p in multi.model_def(cfg.model_class).build(10, device="meta").parameters())
    hidden = (128, 64, 10, 64, 128, 1)
    model = (4 * n_rows * T_BEAT + S * hbm.train_block_hbm_bytes_per_config(0, 0, T_BEAT, 128, hidden, p_count)
             + hbm.recurrent_working_set_bytes(T_BEAT, 128, hidden))
    cap = multi._config_axis_cap(cfg.model_class, 10, cfg.batch_size, TRAIN_BEATS, T_BEAT)
    print(f"[many] multi AE, {S} configs: peak device memory {peak / 2**20:.1f} MiB, core/hbm.py's count "
          f"{model / 2**20:.1f} MiB; its config cap on this card {cap}")
    print(f"[many] cli.main_ae -m test on {os.path.basename(runs[0])}: loss {test[0]:.6f}; lstm_encoder launches in "
          f"the multi-config training and test {launches}")
    check(len(runs) == S and len(grouped) == 2 and all(os.path.isdir(d) for d in runs + grouped),
          "multi-config run dirs")
    check(np.isfinite(test[0]) and launches > 0, f"multi-config test pass: loss {test[0]}, launches {launches}")
    multi_checks(torch, dev, os.path.dirname(lstm["data"]))
    return launches


def phase_many_models(torch, dev, lstm):
    """Phase 11 on phase 8's data and step time (``lstm``); returns the
    encoder kernel's launches on its main path."""
    stacked_tf32_check(torch, dev)
    working_set_probe(torch, dev)
    with workdir(os.path.dirname(lstm["data"])) as work:
        phase_dl(torch, dev, work)
    return phase_multi(torch, dev, lstm)


# phase 12: several ranks; (a) one NCCL rank on the card, (b) two gloo ranks sharing the card
PAR_STEPS = 20  # sharded steps of (a), at phase 8's B=128 on phase 8's beats
PAR_TIMED_FROM = 2  # steps before this one warm up (cuDNN plans, NCCL's first all-reduce)
PAR_B_JOBS = [
    ("ae", 1, dict(latent=10, batch=128, optimizer="adam", steps=4)),
    ("gbt", 1, dict(n_seeds=8, n_per=2500, F=10, params=dict(GBT_PARAMS, gamma=0.0, min_child_weight=1.0,
                                                             subsample=0.8, colsample_bytree=0.8))),
    ("multi", 1, dict(seeds=[3, 4], n_beats=192, n_cases=12, latent=10)),
    ("extract", 1, dict(n_records=2, duration_s=180.0, windows_per_batch=8)),
    ("tp", 2, None),  # the pair on the (1, 2) grid; its inputs are made in phase_multichip
]


def tp_inputs(rng, d_in: int = 64, hidden: int = 256, n: int = 128):
    params = {"w1": (rng.standard_normal((d_in, hidden)) * 0.1).astype(np.float32), "b1": np.zeros(hidden, np.float32),
              "w2": (rng.standard_normal((hidden, 1)) * 0.1).astype(np.float32), "b2": np.zeros(1, np.float32)}
    return dict(params=params, x=rng.standard_normal((n, d_in)).astype(np.float32),
                y=rng.standard_normal(n).astype(np.float32), lr=0.1)


def tp_unsharded(torch, dev, params, x, y, lr):
    """The pair's MLP on one device: its output and one SGD step's params and loss."""
    p = {k: torch.as_tensor(v, device=dev).requires_grad_(True) for k, v in params.items()}
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    out = torch.relu(xt @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    loss = torch.mean(torch.square(out[:, 0] - yt))
    loss.backward()
    return out.detach().cpu().numpy(), {k: (v - lr * v.grad).detach().cpu().numpy() for k, v in p.items()}, loss.item()


def ae_close(got, want):
    """The largest relative loss difference and the largest parameter
    difference beyond rtol 2e-4 (as a multiple of atol 2e-5 + 2e-4 |want|)."""
    loss_rel = float(np.max(np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])))
    param = max(float(np.max(np.abs(got["params"][l][k] - want["params"][l][k])
                             / (2e-5 + 2e-4 * np.abs(want["params"][l][k]))))
                for l in want["params"] for k in want["params"][l])
    return loss_rel, param, float(abs(got["val"] - want["val"]) / abs(want["val"]))


def phase_multichip(torch, dev, lstm):
    """Phase 12 on phase 8's beats; returns the three kernels' launches in
    its ranks."""
    from ae_waveforms_tpu_torch.core import flops
    from ae_waveforms_tpu_torch.core.schema import load_arrays
    from ae_waveforms_tpu_torch.parallel import dryrun

    waves = load_arrays(lstm["data"]).waves
    # (a) the sharded step at world 1 over NCCL against phase 8's step on the same beats, init and generator
    kw = dict(latent=10, batch=128, optimizer="adam", waves=waves[:PAR_STEPS * 128], steps=PAR_STEPS, timed=True)
    t0 = time.perf_counter()
    a = dryrun.run_sharded([("ae", 1, kw)], ["cuda:0"], "nccl", timeout_s=300)
    wall_a = time.perf_counter() - t0
    one = dryrun.ae_steps(dev, None, **kw)
    got = a["results"][0]
    loss_rel, param, val_rel = ae_close(got, one)
    ms, ms_one = (float(np.median(r["step_ms"][PAR_TIMED_FROM:])) for r in (got, one))
    step_flops = 128 * flops.lstm_ae_train_flops_per_sample()
    bit = bool(np.array_equal(got["losses"], one["losses"]))
    print(f"[multichip] (a) world 1 over NCCL on cuda:0, {PAR_STEPS} sharded steps of the default LSTM AE at B=128 "
          f"on phase 8's beats ({wall_a:.2f} s wall, the rank's start and build load included): ms per step p50 "
          f"{ms:.4f} (CUDA events, synchronised each step, steps {PAR_TIMED_FROM} on) beside {ms_one:.4f} for the "
          f"single-device step in this process and phase 8's {lstm['step_ms']:.4f}; the gradient all-reduce "
          f"({got['allreduce_bytes']} bytes) {got['allreduce_ms'] * 1e3:.2f} us p50 of 50; MFU {mfu_of(torch, step_flops, ms):.5f} "
          f"(single device {mfu_of(torch, step_flops, ms_one):.5f}, phase 8 {mfu_of(torch, step_flops, lstm['step_ms']):.5f})")
    print(f"[multichip] (a) against the single-device steps: losses bit-identical {bit}, max relative "
          f"{loss_rel:.3e} (tolerance 1e-5, phase 8's card repeat); params at most {param:.3f} of rtol 2e-4 + atol "
          f"2e-5; validation relative {val_rel:.3e}")
    check(loss_rel <= 1e-5 and param <= 1.0 and val_rel <= 1e-5, "the NCCL world-1 steps differ from one device's")

    # (b) two gloo ranks on one card, each workload against its one-device run
    jobs = [(name, mp, tp_inputs(np.random.default_rng(12)) if name == "tp" else
             dict(kw_, waves=waves[:512]) if name == "ae" else kw_) for name, mp, kw_ in PAR_B_JOBS]
    t0 = time.perf_counter()
    b = dryrun.run_sharded(jobs, ["cuda:0", "cuda:0"], "gloo", timeout_s=600)
    wall_b = time.perf_counter() - t0
    res = dict(zip([j[0] for j in jobs], b["results"]))
    want = {name: dryrun.WORKLOADS[name](dev, None, **kw_) for name, _, kw_ in jobs if name != "tp"}
    loss_rel, param, val_rel = ae_close(res["ae"], want["ae"])
    print(f"[multichip] (b) two ranks on cuda:0 over gloo ({wall_b:.2f} s wall; gloo, one card: no measurement of "
          f"a user path): the AE step at B=128 split 64 + 64, 4 steps: losses max relative {loss_rel:.3e} "
          f"(tolerance 2e-5), params at most {param:.3f} of rtol 2e-4 + atol 2e-5, validation {val_rel:.3e}")
    check(loss_rel <= 2e-5 and param <= 1.0 and val_rel <= 2e-5, "the 2-rank AE step differs from one device's")
    gbt_same = bool(np.array_equal(res["gbt"], want["gbt"]))
    multi_same = all(np.array_equal(res["multi"][k], want["multi"][k], equal_nan=True)
                     for k in ("train_losses", "val_losses", "best_val"))
    ext_same = ([c[0] for c in res["extract"]] == [c[0] for c in want["extract"]]
                and all(g[4] == w[4] and all(x.tobytes() == y.tobytes() for x, y in zip(g[1:4], w[1:4]))
                        for g, w in zip(res["extract"], want["extract"])))
    tp_out, tp_params, tp_loss = tp_unsharded(torch, dev, **tp_inputs(np.random.default_rng(12)))
    tp_err = float(np.abs(res["tp"]["out"] - tp_out).max())
    tp_perr = max(float(np.max(np.abs(res["tp"]["params"][k] - v) / (1e-6 + 1e-5 * np.abs(v))))
                  for k, v in tp_params.items())
    print(f"[multichip] (b) 8-seed GBT fit split 4 + 4 ({res['gbt'].shape} probabilities): exact {gbt_same}; "
          f"multi-config AE, 2 configs split 1 + 1: bit-identical {multi_same}; extraction of 2 records in chunks of 8 "
          f"windows split 4 + 4 ({sum(len(c[1]) for c in res['extract'])} beats): byte-equal {ext_same}; "
          f"tensor-parallel pair on (1, 2): output max_abs_err {tp_err:.3e} (tolerance 1e-6), step params at most "
          f"{tp_perr:.3f} of rtol 1e-5 + atol 1e-6, loss {res['tp']['loss']:.6f} against {tp_loss:.6f}")
    check(gbt_same and multi_same and ext_same, "a 2-rank result differs from one device's")
    check(tp_err <= 1e-6 and tp_perr <= 1.0 and abs(res["tp"]["loss"] - tp_loss) <= 1e-6 * abs(tp_loss),
          "the tensor-parallel pair differs from the unsharded MLP")
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    print(f"[multichip] kernel launches in the ranks: (a) {a['launches']}, (b) {b['launches']}")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched in the ranks: {launches}")
    check(launches["gbt_split"] == launches["gbt_hist"], f"the ranks' fit levels split in one launch: {launches}")
    check(launches["gbt_grad"] == launches["gbt_leaves"], f"the ranks' fit trees end as they start: {launches}")
    return launches


# phase 13: the repo's end-to-end run (examples/run_e2e.py's port) at the JAX example's defaults
STUDY_RTOL, STUDY_ATOL = 1e-5, 1e-7  # phase 9's objective tolerance, for the study's MSE and RMSE
# phase 7's card-against-CPU margin tolerance, for leaf weights and, through
# the sigmoid's largest slope 1/4, for probabilities
GBT_MARGIN_TOL = 5e-3


def e2e_predicted_launches(best: dict, latent: int) -> dict:
    """K1, K2, K4, K5 and K6 launches that the code makes in phase 13's card
    run: a fit makes one K1, K2 and K4 a level and one K5 and K6 a tree
    (``gbt._fit_batched``), a prediction the
    launches of ``route_spans`` (``GBTClassifier.predict_proba``); the
    grid search fits each candidate once a fold and predicts its held-out
    fold, the PPV sweep fits ``best`` once a seed and predicts the test
    rows, and the flow fits its head once and predicts once."""
    from ae_waveforms_tpu_torch.classify.lhs import lhs_param_dicts
    from ae_waveforms_tpu_torch.examples.run_e2e import (
        FLOW_DEPTH, FLOW_TREES, GS_CANDIDATES, GS_FOLDS, GS_RANDOM_STATE, PPV_SEEDS,
    )
    from ae_waveforms_tpu_torch.ops.gbt_route import route_spans

    cands = lhs_param_dicts(GS_CANDIDATES, random_state=GS_RANDOM_STATE)
    levels = (GS_FOLDS * sum(p["n_estimators"] * p["max_depth"] for p in cands)
              + PPV_SEEDS * best["n_estimators"] * best["max_depth"] + FLOW_TREES * FLOW_DEPTH)
    trees = GS_FOLDS * sum(p["n_estimators"] for p in cands) + PPV_SEEDS * best["n_estimators"] + FLOW_TREES
    predicts = (GS_FOLDS * sum(len(route_spans(latent, 0, p["max_depth"])) for p in cands)
                + PPV_SEEDS * len(route_spans(latent, 0, best["max_depth"]))
                + len(route_spans(latent, 0, FLOW_DEPTH)))
    return {"gbt_hist": levels, "gbt_route": levels + predicts, "gbt_split": levels, "gbt_grad": trees,
            "gbt_leaves": trees}


def recording_gbt(base):
    """A subclass of ``base`` (``GBTClassifier``) that keeps every instance
    it fits, with the fit's rows and each prediction's rows and
    probabilities, so that each card fit can be refitted on the CPU."""

    class Recorded(base):
        fitted = []

        def fit(self, X, y, sample_weight=None):
            self.fit_args = (np.array(X), np.array(y), None if sample_weight is None else np.array(sample_weight))
            self.predictions = []
            Recorded.fitted.append(self)
            return super().fit(X, y, sample_weight)

        def predict_proba(self, X):
            out = super().predict_proba(X)
            self.predictions.append((X.cpu().numpy() if hasattr(X, "cpu") else np.array(X), out))
            return out

    return Recorded


def gbt_refits(torch, fitted) -> None:
    """Each card fit of phase 13 refitted on its own rows, params and seed
    through the plain path on the CPU: the trees' splits (feature, bin,
    flag) must be equal, the leaves and each prediction's probabilities
    within ``GBT_MARGIN_TOL`` (1/4 of it for probabilities)."""
    from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier

    leaf_err = proba_err = 0.0
    shapes = {}
    for m in fitted:
        X, y, w = m.fit_args
        cpu = GBTClassifier(**m.params, random_state=m.random_state, n_bins=m.n_bins, device="cpu").fit(X, y, w)
        key = (m.params["n_estimators"], m.params["max_depth"], len(X))
        shapes[key] = shapes.get(key, 0) + 1
        for name in ("feat", "thresh", "is_split"):
            check(torch.equal(getattr(m._ens, name).cpu(), getattr(cpu._ens, name)),
                  f"a card fit of {key[0]} trees of depth {key[1]} on {key[2]} rows grows other trees than the "
                  f"CPU's ({name})")
        leaf_err = max(leaf_err, float((m._ens.leaf.cpu() - cpu._ens.leaf).abs().max()))
        check(len(m.predictions) > 0, f"a card fit of {key} predicted nothing")
        for rows, proba in m.predictions:
            proba_err = max(proba_err, float(np.abs(proba - cpu.predict_proba(rows)).max()))
    print(f"[e2e] the card's {len(fitted)} GBT fits refitted on the CPU (trees, depth, rows: fits "
          f"{', '.join(f'{k}: {v}' for k, v in sorted(shapes.items()))}): splits equal; leaves max_abs_err "
          f"{leaf_err:.3e} (tolerance {GBT_MARGIN_TOL}), probabilities max_abs_err {proba_err:.3e} (tolerance "
          f"{GBT_MARGIN_TOL / 4})")
    check(leaf_err <= GBT_MARGIN_TOL and proba_err <= GBT_MARGIN_TOL / 4,
          f"the card's GBT leaves or probabilities part from the CPU refit's: {leaf_err}, {proba_err}")


def phase_e2e(torch, dev, work=None):
    """Phase 13: ``examples.run_e2e`` at its defaults (12 synthetic 120-s
    records, the conv AE for 2 epochs) and its resume-and-serve flow on the
    card; the chain's first four stages again on the CPU, its hand-offs
    card against CPU; and every GBT fit of the card run refitted on the
    CPU.  Returns the histogram and routing kernels' launches on the card."""
    from ae_waveforms_tpu_torch.classify import gbt, harness
    from ae_waveforms_tpu_torch.examples import run_e2e

    with workdir(work) as w:
        card_dir, cpu_dir = os.path.join(w, "e2e_card"), os.path.join(w, "e2e_cpu")
        recorded = recording_gbt(gbt.GBTClassifier)
        originals = harness.GBTClassifier, gbt.GBTClassifier
        harness.GBTClassifier = gbt.GBTClassifier = recorded
        try:
            before = dict(_build.launches)
            t0 = time.perf_counter()
            card = run_e2e.main(["--workdir", card_dir, "--device", str(dev)])
            t1 = time.perf_counter()
            flow = run_e2e.resume_and_serve(card_dir, card["data_dir"], device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = {k: v for k, v in launched(before).items() if k != "lstm_encoder"}
        finally:
            harness.GBTClassifier, gbt.GBTClassifier = originals
        cpu = run_e2e.run_ae(cpu_dir, device="cpu")
        t3 = time.perf_counter()
        gbt_refits(torch, recorded.fitted)
        t4 = time.perf_counter()

        for tag, out in (("card", card), ("CPU", cpu)):
            print(f"[e2e] the chain on the {tag}: " + ", ".join(f"{k} {v:.3f} s" for k, v in out["seconds"].items()))
        print(f"[e2e] the resume-and-serve flow on the card: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in flow["seconds"].items()))
        print(f"[e2e] wall s: chain on the card {t1 - t0:.3f}, flow on the card {t2 - t1:.3f}, the chain's first "
              f"four stages on the CPU {t3 - t2:.3f}, the GBT refits on the CPU {t4 - t3:.3f}")

        same_arrays = all(open(os.path.join(card["data_dir"], f"np_{n}.npy"), "rb").read()
                          == open(os.path.join(cpu["data_dir"], f"np_{n}.npy"), "rb").read() for n in ARRAYS)
        same_split = True
        for split in ("train", "val", "test"):
            (a,), (b,) = (glob.glob(os.path.join(o["run_dir"], f"indices_{split}_*.npy")) for o in (card, cpu))
            same_split = same_split and np.array_equal(np.load(a), np.load(b))
        trad, trad_cpu = card["results"]["study"]["traditional"], cpu["results"]["study"]["traditional"]
        study_err = max(abs(g - w_) / (STUDY_ATOL + STUDY_RTOL * abs(w_)) for g, w_ in
                        ((trad.mse, trad_cpu.mse), (trad.rmse_mean, trad_cpu.rmse_mean),
                         (trad.rmse_median, trad_cpu.rmse_median)))
        n_beats = len(np.load(os.path.join(card["data_dir"], "np_waves.npy")))
        print(f"[e2e] the card against the CPU: np_waves/np_features/np_info ({n_beats} beats) byte-equal "
              f"{same_arrays}; indices_train/val/test equal {same_split}; the study's traditional MSE "
              f"{trad.mse:.8f} (CPU {trad_cpu.mse:.8f}), mean RMSE {trad.rmse_mean:.8f} ({trad_cpu.rmse_mean:.8f}), "
              f"median RMSE {trad.rmse_median:.8f} ({trad_cpu.rmse_median:.8f}): at most {study_err:.3e} of rtol "
              f"{STUDY_RTOL} + atol {STUDY_ATOL}")
        check(same_arrays, "the card's extracted arrays differ from the CPU's")
        check(same_split, "the card run's patient split differs from the CPU run's")
        check(study_err <= 1.0, "the card's traditional reconstruction metrics part from the CPU's")

        _, (loss, rmse, _, prd, _), _, latents = card["results"]["test"]
        ppv, best = card["results"]["ppv"], card["results"]["grid_search"]["best_params"]
        p = flow["score_gbt"]["probability"]
        print(f"[e2e] AE test loss {loss:.6f}, RMSE {rmse:.6f}, PRD {prd:.3f}% on {len(latents)} beats; grid search "
              f"best {best} (CV AUC {card['results']['grid_search']['best_score']:.4f}); PPV sweep median AUC "
              f"{ppv['median_auc']:.4f}, median PPV {ppv['median_ppv']:.4f}; flow resumed at step "
              f"{flow['resumed_step']}, probabilities {p.min():.4f} to {p.max():.4f}")
        check(np.isfinite(rmse) and latents.shape[1] == 10, f"the AE test pass: rmse {rmse}, latents {latents.shape}")
        check(ppv["median_ppv"] > 0.8, f"median PPV {ppv['median_ppv']} on the separated cohorts")
        check(flow["resumed_step"] > 0, "the resumed run did not restore a step")
        check(p.shape == (10,) and bool(np.all((p >= 0) & (p <= 1))), f"GBT head probabilities {p}")

    want = e2e_predicted_launches(best, latents.shape[1])
    print(f"[e2e] kernel launches on the card: {launches}; the code predicts {want}")
    check(launches == want, f"phase 13's launches {launches} are not the code's {want}")
    return launches


# phase 14: (S, n, depth): the widest levels of the grid search's chunks (27 fits to depth 6, 21 to depth 10),
# of the study's (96 and 24), of the PPV sweep's 25 seeds (depth 8) and of one fit on a fold's 149 rows
SPLIT_SHAPES = [(27, 12000, 5), (21, 12000, 9), (96, 12000, 5), (24, 12000, 9), (25, 12500, 7), (1, 149, 8)]
SPLIT_SWEEP_SHAPE = (21, 12000, 9, True)  # the deep chunks' last level, K4's most bytes in the grid search


def phase_split(torch, dev):
    from ae_waveforms_tpu_torch.ops import gbt_split
    from ae_waveforms_tpu_torch.ops.gbt_hist import fixed_point_shift, left_histograms_fixed, pack_bins
    from ae_waveforms_tpu_torch.ops.gbt_split import split_level, split_level_reference

    rng = np.random.default_rng(14)
    F, n_bins = 10, 64
    result = {}
    for S, n, depth in SPLIT_SHAPES:
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        binsT = t(rng.integers(0, n_bins, size=(F, n)).astype(np.int32))
        keep = (rng.random((S, n)) >= 0.46).astype(np.float32)  # held-out and subsampled-out rows weigh nothing
        g = t(rng.standard_normal((S, n)).astype(np.float32) * keep)
        h = t(rng.uniform(0, 1, (S, n)).astype(np.float32) * keep)
        shift = fixed_point_shift(g, h)
        n_nodes = 2**depth
        half = n_nodes // 2
        up = t(rng.integers(0, half, size=(S, n)).astype(np.int32))  # each row's node at the last level
        node = 2 * up + t(rng.integers(0, 2, size=(S, n)).astype(np.int32))
        packed = pack_bins(binsT, n_bins)
        # K1's sums of the level's left children and, from every row at a left child, the last level's nodes
        q = left_histograms_fixed(binsT, g, h, node, shift, half=half, n_bins=n_bins, packed=packed)
        parent = left_histograms_fixed(binsT, g, h, 2 * up, shift, half=half, n_bins=n_bins, packed=packed)
        col = rng.random((S, F)) < 0.8
        col[:, 0] |= ~col.any(1)
        args = (q, parent, shift, t(rng.uniform(0, 0.5, S).astype(np.float32)),
                t(rng.uniform(0.5, 2, S).astype(np.float32)), t(col), t(np.full(S, depth + 1)))
        for last in (False, True):
            heaps = [tuple(torch.zeros((S, 2 * n_nodes), dtype=d, device=dev)
                           for d in (torch.int32, torch.int32, torch.bool)) for _ in range(3)]
            kw = dict(depth=depth, n_bins=n_bins, last=last)
            got, again = (split_level(*args, heap, **kw) for heap in heaps[:2])
            want = split_level_reference(*args, heaps[2], **kw)
            out = (lambda lv: lv.leaf_sums) if last else (lambda lv: lv.hist)
            exact = torch.equal(out(got), out(want)) and all(map(torch.equal, heaps[0], heaps[2]))
            same = torch.equal(out(got), out(again)) and all(map(torch.equal, heaps[0], heaps[1]))
            split_share = heaps[2][2].float().sum().item() / (S * n_nodes)
            where = f"S={S} n={n} depth {depth} ({'last' if last else 'inner'} level)"
            check(same, f"gbt_split is not bit-identical across two calls at {where}")
            check(exact, f"gbt_split differs from the plain version at {where}")

            ms = graph_ms(torch, lambda: split_level(*args, heaps[0], **kw), 20)
            call_ms = event_ms(torch, lambda: split_level(*args, heaps[0], **kw), 20)
            plain_ms = graph_ms(torch, lambda: split_level_reference(*args, heaps[2], **kw), 3)
            # bytes: K1's sums and the last level's node histograms read once (8 bytes a G or H cell), each
            # fit's five scalars and column mask, and written once the level's node histograms (inner) or
            # four int64 leaf sums a node (last) and the 9 bytes of its heap slots; no operation is counted
            cells = S * n_nodes * F * n_bins
            nbytes = 2 * 8 * cells + S * (20 + F) + (32 * S * n_nodes if last else 16 * cells) + 9 * S * n_nodes
            bound_ms, bound_by = bound(nbytes, 0.0)
            warps = gbt_split._warps(F, gbt_split._max_warps())
            print(f"[gbt_split] {where}: exact and bit-identical, {split_share:.3f} of nodes split; "
                  f"{S * n_nodes} blocks of {warps} warps; device ms per call (CUDA graph): kernel {ms:.5f}, plain "
                  f"{plain_ms:.5f}; kernel per call with launch gaps (CUDA events) {call_ms:.5f}; bound "
                  f"{bound_ms:.6f} ms by {bound_by} ({nbytes / 1e6:.2f} MB)")
            if (S, n, depth, last) == SPLIT_SWEEP_SHAPE:
                result = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              warps=warps, split_share=split_share)
    return result


# phase 15: (S, n, depth): the grid search's chunks (27 fits to depth 6, 21 to depth 10), the study's 96, the PPV
# sweep's 25 seeds on 12,500 rows (depth 8) and one fit on a fold's 149 rows
TREE_SHAPES = [(27, 12000, 6), (21, 12000, 10), (96, 12000, 6), (25, 12500, 8), (1, 149, 8)]
TREE_SWEEP_SHAPE = (21, 12000, 10)  # the deep chunks: the most leaves a tree in the grid search


def phase_tree(torch, dev):
    from ae_waveforms_tpu_torch.ops.gbt_tree import (
        tree_grad, tree_grad_reference, tree_leaves, tree_leaves_reference,
    )

    rng = np.random.default_rng(15)
    F, trees, tree = 10, 8, 7
    result = {}
    for S, n, depth in TREE_SHAPES:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        where = f"S={S} n={n} depth {depth}"
        margin = t((rng.standard_normal((S, n)) * 2).astype(np.float32))
        y = t((rng.random(n) < 0.5).astype(np.float32))
        w = t((rng.random((S, n)) < 0.67).astype(np.float32))  # a fold's held-out rows weigh nothing
        rates = t(rng.uniform(0.5, 1, S).astype(np.float32))
        grad_args = (margin, y, w, t(rng.integers(0, 2**31, S)), rates, rates)
        masks = dict(row_mask=t(rng.random((S, trees, n)) < 0.7)[:, tree],
                     col_mask=t(rng.random((S, trees, F)) < 0.6)[:, tree])
        for kind, kw in (("drawn", {}), ("injected", masks)):
            kw = dict(kw, tree=tree, n_features=F)
            got, again = tree_grad(*grad_args, **kw), tree_grad(*grad_args, **kw)
            want = tree_grad_reference(*grad_args, **kw)
            check(all(map(torch.equal, got, again)), f"gbt_grad is not bit-identical across two calls at {where}")
            check(all(map(torch.equal, got, want)), f"gbt_grad differs from the plain version at {where}, {kind} masks")
        # the last level's leaf sums of realistic size (0 <= HL <= H), rows at random leaves
        L = 2**depth
        H = rng.integers(0, 2**42, (S, L // 2))
        HL = (H * rng.random((S, L // 2))).astype(np.int64)
        G, GL = rng.integers(-2**41, 2**41, (2, S, L // 2))
        leaves_args = (t(np.stack([GL, HL, G, H], -1)), got.shift, rates, t(np.full(S, trees)),
                       t(rng.integers(0, L, (S, n)).astype(np.int32)))
        outs = [(margin.clone(), torch.zeros((S, trees, L), device=dev)) for _ in range(3)]
        tree_leaves(*leaves_args, *outs[0], tree=tree)
        tree_leaves(*leaves_args, *outs[1], tree=tree)
        tree_leaves_reference(*leaves_args, *outs[2], tree=tree)
        check(all(map(torch.equal, outs[0], outs[1])), f"gbt_leaves is not bit-identical across two calls at {where}")
        check(all(map(torch.equal, outs[0], outs[2])), f"gbt_leaves differs from the plain version at {where}")

        kw = dict(tree=tree, n_features=F)
        timings = {
            "gbt_grad": (lambda: tree_grad(*grad_args, **kw), lambda: tree_grad_reference(*grad_args, **kw),
                         # margin, row weight, g, h and node ids a row; y once; seed, rates, shift and columns a fit
                         20 * S * n + 4 * n + S * (20 + F)),
            "gbt_leaves": (lambda: tree_leaves(*leaves_args, *outs[0], tree=tree),
                           lambda: tree_leaves_reference(*leaves_args, *outs[2], tree=tree),
                           # node id, margin read and written a row; the sums and the leaf written a leaf pair
                           12 * S * n + 40 * S * L // 2 + 16 * S),
        }
        for name, (kernel, plain, nbytes) in timings.items():
            ms = graph_ms(torch, kernel, 20)
            call_ms = event_ms(torch, kernel, 20)
            plain_ms = graph_ms(torch, plain, 3)
            bound_ms, bound_by = bound(nbytes, 0.0)
            print(f"[gbt_tree] {name} at {where}: exact and bit-identical; device ms per call (CUDA graph): kernel "
                  f"{ms:.5f}, plain {plain_ms:.5f}; kernel per call with launch gaps (CUDA events) {call_ms:.5f}; "
                  f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes / 1e6:.3f} MB)")
            if (S, n, depth) == TREE_SWEEP_SHAPE:
                result[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch.cuda.get_device_name(0) = {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNELS)} CUDA kernel sources and {len(_build.HOST_SOURCES)} host library built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in [*_build.KERNELS, *_build.HOST_SOURCES]:
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
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:  # phase 8's data and LSTM run, for phase 9
        train_launches, lstm = timed("8 AE train and test", phase_train, torch, dev, work)
        study_launches = timed("9 conv AE and reconstruction study", phase_reconstruction, torch, dev, lstm)
        timed("10 extraction", phase_extract, torch, dev, work)
        many_launches = timed("11 many models", phase_many_models, torch, dev, lstm)
        par_launches = timed("12 several ranks", phase_multichip, torch, dev, lstm)
        e2e_launches = timed("13 end to end", phase_e2e, torch, dev, work)
    split = timed("14 gbt_split", phase_split, torch, dev)
    tree = timed("15 gbt_tree", phase_tree, torch, dev)

    kernels = [
        dict(name="lstm_encoder", route="cuda", source="ae_waveforms_tpu_torch/csrc/lstm_encoder.cu",
             replaces="ae_waveforms_tpu/ops/lstm_pallas.py:109",
             launches=serve_launches["lstm_encoder"] + train_launches + study_launches["lstm_encoder"] + many_launches
             + par_launches["lstm_encoder"], **encoder),
        dict(name="gbt_route", route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_route.cu",
             replaces="ae_waveforms_tpu/ops/gbt_route_pallas.py:167",
             launches=serve_launches["gbt_route"] + classify_launches["gbt_route"] + study_launches["gbt_route"]
             + par_launches["gbt_route"] + e2e_launches["gbt_route"], **route),
        dict(name="gbt_hist", route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_hist.cu",
             replaces="ae_waveforms_tpu/ops/gbt_hist_pallas.py:193",
             launches=classify_launches["gbt_hist"] + par_launches["gbt_hist"] + e2e_launches["gbt_hist"], **hist),
        dict(name="gbt_split", route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_split.cu", replaces=None,
             launches=classify_launches["gbt_split"] + par_launches["gbt_split"] + e2e_launches["gbt_split"], **split),
        *(dict(name=name, route="cuda", source="ae_waveforms_tpu_torch/csrc/gbt_tree.cu", replaces=None,
               launches=classify_launches[name] + par_launches[name] + e2e_launches[name], **tree[name])
          for name in ("gbt_grad", "gbt_leaves")),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
