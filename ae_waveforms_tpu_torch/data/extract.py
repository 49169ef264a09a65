"""Per-case extraction pipeline (counterpart of the JAX package's
``data/extract.py``; reference: data_extract_vitaldb.py:23-219).

Record -> trim NaN edges -> z-score -> HP(1 Hz) -> LP(30 Hz) -> 20-s windows
-> per-window z-score -> R peaks -> QC -> median beats -> delineation -> the
35 median features.

The host runs I/O, the per-case cache (one ``{case_id}.npz`` per case,
short-circuited on re-run: idempotent and resumable, in the JAX package's
format, so either package reads the other's cache), the record filter
(scipy in float64 unless ``filter_backend="device"``) and, for the
``host``/``python`` engines, delineation and features in float64.  The
device runs R peaks, QC and median beats in float32 on every path, and the
``device`` engine's delineation and features.

Three engines (``ExtractionConfig.delineation_engine``): ``host``, the C++
delineator (``ops/native_delineate.py``; a failed build raises), ``python``,
the pure-Python one, and ``device``, ``signals.delineate_device`` in float32.
``batched=True`` pools windows across cases; with the device engine it
streams chunks of ``windows_per_batch`` windows through one pass on the
device each (``_window_pass``).

Host syncs are explicit: one pull a case (or chunk) of everything the host
needs, plus one a chunk re-run at full width.  ``ExtractionStats`` counts
them and times the stages where the caller passes one.

Over several devices (``mesh``, a ``parallel.mesh.Grid``; the batched device
engine only) every rank prepares the same chunks, passes its contiguous
block of each chunk's windows on its device, and the blocks are gathered
in window order on every rank, so every rank assembles the same cases in
case order.  Every rank reads the cache as it stood when the call began;
rank 0 alone writes it.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import ExtractionConfig
from ae_waveforms_tpu_torch.parallel.mesh import Grid, gather_blocks
from ae_waveforms_tpu_torch.signals.delineate import delineate
from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch
from ae_waveforms_tpu_torch.signals.features import median_feature_row, morphology_features, relative_to_r
from ae_waveforms_tpu_torch.signals.features_device import feature_rows_batch
from ae_waveforms_tpu_torch.signals.filters import butterworth, butterworth_batched, zscore
from ae_waveforms_tpu_torch.signals.median_beat import median_beat_batch
from ae_waveforms_tpu_torch.signals.qc import qc_mask
from ae_waveforms_tpu_torch.signals.rpeaks import LIGHT_CANDIDATES, find_rpeaks_batch
from ae_waveforms_tpu_torch.signals.segment import segment_record

__all__ = [
    "CaseResult",
    "ExtractionStats",
    "K_LIGHT",
    "extract_case",
    "extract_cases",
    "extract_cases_batched",
    "preprocess_record",
    "preprocess_records_batched",
]

#: light beat width of the device engine's chunk pass: every stage after
#: the R peaks costs about linearly in the (B, K) beat grid, and K's
#: provable bound (68 slots for 20 s at the 0.3 s refractory) is ~2.9x the
#: typical beat count.  48 slots cover every window up to HR 144; a chunk
#: with a faster window is seen in the pulled peak counts and re-run at the
#: full width.
K_LIGHT = 48
#: columns of a chunk pass's packed (B, 358) float32 result
_KEEP, _VALID, _WAVES, _FEATS, _NPEAKS = 0, 1, slice(2, 322), slice(322, 357), 357


@dataclass
class CaseResult:
    case_id: int
    waves: np.ndarray  # (n, 320) float32 median beats
    features: np.ndarray  # (n, 35)
    indices: np.ndarray  # (n,) window-end sample indices
    n_windows_raw: int = 0  # before QC


@dataclass
class ExtractionStats:
    """What one extraction run did, filled where the caller passes one.

    ``host_s``: host wall seconds by stage (a device stage's are the time to
    issue it); ``device_ms``: device milliseconds by stage from CUDA events
    (read after ``finish``); ``passes``: device passes over a chunk or case;
    ``syncs``: the passes' host syncs (device -> host pulls; the device
    filter's one pull a length bucket is not counted); ``reruns``: chunks
    re-run at the full beat width; ``windows``: windows through the
    device."""

    host_s: Dict[str, float] = field(default_factory=dict)
    device_ms: Dict[str, float] = field(default_factory=dict)
    passes: int = 0
    syncs: int = 0
    reruns: int = 0
    windows: int = 0
    _events: list = field(default_factory=list, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        ev = None
        if device is not None and torch.device(device).type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ev is not None:
                ev[1].record()
            with self._lock:
                self.host_s[name] = self.host_s.get(name, 0.0) + dt
                if ev is not None:
                    self._events.append((name, ev))

    def count(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def finish(self) -> None:
        """Wait for the device and turn the recorded events into
        ``device_ms``."""
        if self._events:
            torch.cuda.synchronize()
        with self._lock:
            for name, (a, b) in self._events:
                self.device_ms[name] = self.device_ms.get(name, 0.0) + a.elapsed_time(b)
            self._events.clear()


def _stage(stats: Optional[ExtractionStats], name: str, device=None):
    return stats.stage(name, device) if stats is not None else contextlib.nullcontext()


def _count(stats: Optional[ExtractionStats], **kw) -> None:
    if stats is not None:
        stats.count(**kw)


def _candidate_slots(windows: np.ndarray) -> int:
    """The R-peak detector's candidate buffer for these windows, chosen on
    the host: the light ``LIGHT_CANDIDATES`` where every window's count of
    strict interior local maxima (a bound on its prominence candidates)
    fits, else the provable (T-1)//2+1."""
    T = windows.shape[1]
    provable = (T - 1) // 2 + 1
    if not len(windows) or provable <= LIGHT_CANDIDATES:
        return provable
    m = (windows[:, 1:-1] > windows[:, :-2]) & (windows[:, 1:-1] > windows[:, 2:])
    return LIGHT_CANDIDATES if int(m.sum(axis=1).max()) <= LIGHT_CANDIDATES else provable


def _trim_zscore(record: np.ndarray, dtype) -> np.ndarray:
    """NaN-edge trim + global z-score."""
    finite = ~np.isnan(record)
    if not finite.any():
        return np.asarray(record[:0], dtype)
    start = int(np.argmax(finite))
    end = len(record) - int(np.argmax(finite[::-1]))
    return np.asarray(zscore(np.asarray(record[start:end], dtype)), dtype)


def preprocess_record(record: np.ndarray, cfg: ExtractionConfig, device=None) -> np.ndarray:
    """Trim NaN edges, z-score, zero-phase HP+LP (data_extract_vitaldb.py:
    53-78).  float64 and ``filter_backend="host"`` run scipy's filtfilt in
    float64 math (float32 differs from it by the final cast only);
    ``filter_backend="device"`` with float32 runs the batched filtfilt on
    ``device``."""
    if cfg.precision == "float64":
        rec = _trim_zscore(record, np.float64)
        for btype, cut in (("high", cfg.butter_hp_ecg), ("low", cfg.butter_lp_ecg)):
            if cut:
                rec = butterworth(rec, btype, cut, cfg.sampling_frequency, cfg.butter_order, "float64")
        return rec
    rec = _trim_zscore(record, np.float32)
    fp = "float64" if cfg.filter_backend == "host" else "float32"
    for btype, cut in (("high", cfg.butter_hp_ecg), ("low", cfg.butter_lp_ecg)):
        if cut:
            rec = butterworth(rec, btype, cut, cfg.sampling_frequency, cfg.butter_order, fp, device=device)
    return np.asarray(rec, np.float32)


def preprocess_records_batched(records: List[np.ndarray], cfg: ExtractionConfig, device=None) -> List[np.ndarray]:
    """``preprocess_record`` over many records: with float32 and
    ``filter_backend="device"`` the segments of every record go through
    ``butterworth_batched`` together, one batch on ``device`` per length
    bucket; else the per-record scipy chain."""
    if cfg.precision == "float64" or cfg.filter_backend == "host":
        return [preprocess_record(r, cfg) for r in records]
    trimmed = [_trim_zscore(r, np.float32) for r in records]
    return butterworth_batched(trimmed, cfg.butter_hp_ecg or None, cfg.butter_lp_ecg or None,
                               cfg.sampling_frequency, cfg.butter_order, device=device)


def _check_resample(cfg: ExtractionConfig) -> None:
    if cfg.delineation_resample != "linear" and cfg.delineation_engine != "python":
        raise ValueError(
            f"delineation_resample={cfg.delineation_resample!r} is a python-engine "
            "sensitivity probe; the host and device engines implement the 'linear' "
            "contract only (signals/delineate.py RESAMPLE_METHODS)"
        )


def _windows(rec: np.ndarray, cfg: ExtractionConfig):
    """20-s windows of a filtered record, each z-scored (NaN-aware, float64
    statistics; the reference's apply_along_axis(zscore, 1, ...)), and their
    end indices."""
    samples, indices = segment_record(rec, cfg.sampling_frequency, cfg.sample_length)
    if len(samples):
        with np.errstate(all="ignore"):
            mu = np.nanmean(samples, axis=1, keepdims=True)
            sd = np.nanstd(samples, axis=1, keepdims=True)
            samples = (samples - mu) / sd
    return samples, indices.reshape(-1)


def _feature_rows(samples: np.ndarray, peaks: np.ndarray, n_peaks: np.ndarray, cfg: ExtractionConfig,
                  stats: Optional[ExtractionStats] = None):
    """float64 delineation and 35-feature rows of the ``host`` and
    ``python`` engines (data_extract_vitaldb.py:118-169): a window without
    peaks is dropped; with the ``python`` engine a delineation exception
    gives an all-NaN row and keeps the window (the reference's bare
    except)."""
    n = len(samples)
    rows = np.full((n, 35), np.nan)
    valid = n_peaks > 0
    with _stage(stats, "delineation"):
        if cfg.delineation_engine == "host":
            from ae_waveforms_tpu_torch.ops.native_delineate import delineate_batch_native

            fids = delineate_batch_native(samples, peaks, n_peaks, cfg.sampling_frequency)
            per_window = [{k: [np.nan if np.isnan(v) else int(v) for v in fids[k][i][: n_peaks[i]]]
                           for k in fids} for i in range(n)]
        else:
            per_window = []
            for i in range(n):
                try:
                    per_window.append(delineate(samples[i], list(map(int, peaks[i][: n_peaks[i]])),
                                                cfg.sampling_frequency, resample_method=cfg.delineation_resample))
                except Exception:  # parity: the reference's bare except -> NaN row, window kept
                    per_window.append(None)
    with _stage(stats, "features"):
        for i in range(n):
            fid = per_window[i]
            if not valid[i] or fid is None:
                continue
            r_peaks = list(map(int, peaks[i][: n_peaks[i]]))
            rel = relative_to_r(samples[i], fid, r_peaks, cfg.sampling_frequency)
            rows[i] = median_feature_row(rel, morphology_features(rel, len(r_peaks)))
    return rows, valid


def _window_pass(x: torch.Tensor, cfg: ExtractionConfig, slots: int, k_width: Optional[int],
                 stats: Optional[ExtractionStats], device_features: bool):
    """One pass over (B, T) float32 windows on their device: R peaks -> QC
    -> median beats, and with ``device_features`` delineation -> features.
    Returns the packed (B, 358) float32 ``[keep, valid, median(320),
    features(35), n_peaks]`` (features NaN without ``device_features``) and
    the (B, K) R peaks.  ``k_width`` cuts the beat grid: a window with more
    peaks than that must be re-run without it."""
    dev = x.device
    fs = cfg.sampling_frequency
    with _stage(stats, "rpeaks", dev):
        peaks, n_peaks = find_rpeaks_batch(x, fs, candidate_slots=slots)
        if k_width is not None and peaks.shape[1] > k_width:
            peaks = peaks[:, :k_width]
    with _stage(stats, "qc", dev):
        keep = qc_mask(x, peaks, n_peaks, fs, cfg.pvc_threshold, cfg.sd_threshold_ecg)
    with _stage(stats, "median", dev):
        medians = median_beat_batch(x, peaks, n_peaks)
    rows = torch.full((x.shape[0], 35), float("nan"), device=dev)
    if device_features:
        with _stage(stats, "delineation", dev):
            fid = delineate_batch(x, peaks, n_peaks, fs)
        with _stage(stats, "features", dev):
            rows = feature_rows_batch(x, peaks, n_peaks, fid, fs)
    _count(stats, passes=1, windows=x.shape[0])
    f = torch.float32
    packed = torch.cat([keep[:, None].to(f), (n_peaks > 0)[:, None].to(f), medians, rows, n_peaks[:, None].to(f)], 1)
    return packed, peaks


def _empty(case_id: int, n_raw: int = 0) -> CaseResult:
    return CaseResult(case_id, np.zeros((0, 320), np.float32), np.zeros((0, 35)), np.zeros((0,)), n_raw)


def _cache_path(cache_dir: Optional[str], case_id: int) -> Optional[str]:
    return None if cache_dir is None else os.path.join(cache_dir, f"{case_id}.npz")


def _load_case(path: str, case_id: int) -> CaseResult:
    z = np.load(path)
    return CaseResult(case_id, z["waves"], z["features"], z["indices"], int(z["n_raw"]))


def _save_case(cache_dir: Optional[str], case_id: int, r: CaseResult, stats=None) -> None:
    if cache_dir is None:
        return
    with _stage(stats, "write"):
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(os.path.join(cache_dir, f"{case_id}.npz"), waves=r.waves, features=r.features,
                 indices=r.indices, n_raw=r.n_windows_raw)


def _extract_windows(windows: np.ndarray, cfg: ExtractionConfig, device, stats):
    """QC'd median beats and feature rows of a batch of z-scored windows
    (float64 or float32 numpy): one device pass, one pull, then the host
    engines' delineation.  Returns (keep, valid among kept, medians, rows)."""
    w32 = np.ascontiguousarray(windows, np.float32)
    device_features = cfg.delineation_engine == "device"
    packed, peaks = _window_pass(torch.from_numpy(w32).to(device), cfg, _candidate_slots(w32), None, stats,
                                 device_features)
    with _stage(stats, "pull"):  # peaks (< 2^24) ride along as float32: one pull
        pulled = torch.cat([packed, peaks.to(torch.float32)], 1).cpu().numpy()
    _count(stats, syncs=1)
    packed, peaks = pulled[:, : _NPEAKS + 1], pulled[:, _NPEAKS + 1 :].astype(np.int64)
    keep = packed[:, _KEEP] > 0.5
    n_peaks = packed[keep, _NPEAKS].astype(np.int64)
    medians = packed[keep, _WAVES]
    if device_features:
        return keep, n_peaks > 0, medians, packed[keep, _FEATS].astype(np.float64)
    rows, valid = _feature_rows(windows[keep], peaks[keep], n_peaks, cfg, stats)
    return keep, valid, medians, rows


def extract_case(case_id: int, record: Optional[np.ndarray], cfg: ExtractionConfig,
                 cache_dir: Optional[str] = None, device=None,
                 stats: Optional[ExtractionStats] = None) -> CaseResult:
    """The full pipeline for one record on ``device`` (``cuda:0`` unless
    named); read from, or written to, the per-case cache when
    ``cache_dir`` is given."""
    _check_resample(cfg)
    path = _cache_path(cache_dir, case_id)
    if path is not None and os.path.exists(path):
        return _load_case(path, case_id)
    device = resolve_device(device)
    with _stage(stats, "filter"):
        rec = preprocess_record(record, cfg, device)
    with _stage(stats, "segment"):
        samples, indices = _windows(rec, cfg)
    if len(samples) == 0:
        result = _empty(case_id)
    else:
        keep, valid, medians, rows = _extract_windows(samples, cfg, device, stats)
        result = CaseResult(case_id, medians[valid].astype(np.float32), rows[valid], indices[keep][valid],
                            len(samples))
    _save_case(cache_dir, case_id, result, stats)
    return result


def _prefetching_loader(record_loader: Callable, case_ids: Sequence[int], depth: int = 2):
    """Background-thread record prefetch, overlapping the record fetch with
    the rest of the pipeline (the reference's ``mp.Pool`` preprocessing
    fan-out, data_extract_vitaldb.py:194-199, gated by
    ``cfg.parallel_preprocessing``)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        for cid in case_ids:
            q.put((cid, record_loader(cid)))
        q.put(None)

    threading.Thread(target=worker, daemon=True).start()
    cache = {}

    def fetch(cid):
        while cid not in cache:
            item = q.get()
            if item is None:
                return None
            cache[item[0]] = item[1]
        return cache.pop(cid)

    return fetch


def _progress(case_ids, progress: bool):
    if progress:
        try:
            from tqdm import tqdm

            return tqdm(case_ids)
        except ImportError:
            pass
    return case_ids


def extract_cases(
    case_ids: Sequence[int],
    record_loader: Callable[[int], Optional[np.ndarray]],
    cfg: ExtractionConfig,
    cache_dir: Optional[str] = None,
    progress: bool = False,
    batched: bool = False,
    windows_per_batch: int = 512,
    device=None,
    stats: Optional[ExtractionStats] = None,
    mesh: Optional[Grid] = None,
) -> List[CaseResult]:
    """Extract a set of cases on ``device`` (``cuda:0`` unless named).
    ``record_loader`` maps a case id to its record (None skips the case).

    ``batched=True`` pools windows across cases into batches of at least
    ``windows_per_batch``; with the device engine it streams chunks of
    exactly that many, split over the grid's ranks with ``mesh``.
    ``cfg.parallel_preprocessing`` prefetches records on a background
    thread."""
    device = resolve_device(device)
    if mesh is not None and not batched:
        raise ValueError("mesh sharding applies to the batched device engine only (batched=True)")
    if cfg.parallel_preprocessing:
        uncached = [cid for cid in case_ids if not os.path.exists(_cache_path(cache_dir, cid) or "")]
        record_loader = _prefetching_loader(record_loader, uncached)
    if batched:
        return extract_cases_batched(case_ids, record_loader, cfg, cache_dir, progress, windows_per_batch,
                                     device, stats, mesh)
    results = []
    for cid in _progress(case_ids, progress):
        path = _cache_path(cache_dir, cid)
        if path is not None and os.path.exists(path):
            results.append(_load_case(path, cid))
            continue
        record = record_loader(cid)
        if record is None:
            continue
        results.append(extract_case(cid, record, cfg, cache_dir, device, stats))
    return results


def extract_cases_batched(
    case_ids: Sequence[int],
    record_loader: Callable[[int], Optional[np.ndarray]],
    cfg: ExtractionConfig,
    cache_dir: Optional[str] = None,
    progress: bool = False,
    windows_per_batch: int = 512,
    device=None,
    stats: Optional[ExtractionStats] = None,
    mesh: Optional[Grid] = None,
) -> List[CaseResult]:
    """Cross-case batched pipeline.  The device engine streams (see
    ``_extract_cases_batched_device``), its chunks split over the grid's
    ranks with ``mesh``; the host engines pool the windows of whole cases
    until a group holds ``windows_per_batch`` and run each group as one case
    would run (``mesh`` does not apply: their hot loop is the host
    delineator)."""
    device = resolve_device(device)
    _check_resample(cfg)
    if cfg.delineation_engine == "device":
        return _extract_cases_batched_device(case_ids, record_loader, cfg, cache_dir, progress,
                                             windows_per_batch, device, stats, mesh)
    if mesh is not None:
        raise ValueError(f"mesh sharding applies to delineation_engine='device' only "
                         f"(got engine={cfg.delineation_engine!r})")
    results: List[CaseResult] = []
    pending: List[tuple] = []  # (cid, samples, indices)

    def flush():
        if not pending:
            return
        spans = np.cumsum([0] + [len(s) for _, s, _ in pending])
        keep, valid, medians, rows = _extract_windows(np.concatenate([s for _, s, _ in pending]), cfg, device,
                                                      stats)
        kept_case = np.repeat(np.arange(len(pending)), np.diff(spans))[keep]
        for ci, (cid, samples, indices) in enumerate(pending):
            sel = kept_case == ci
            v = valid[sel]
            res = CaseResult(cid, medians[sel][v].astype(np.float32), rows[sel][v],
                             indices[keep[spans[ci] : spans[ci + 1]]][v], len(samples))
            _save_case(cache_dir, cid, res, stats)
            results.append(res)
        pending.clear()

    n_windows = 0
    for cid in _progress(case_ids, progress):
        path = _cache_path(cache_dir, cid)
        if path is not None and os.path.exists(path):
            results.append(_load_case(path, cid))
            continue
        record = record_loader(cid)
        if record is None:
            continue
        with _stage(stats, "filter"):
            rec = preprocess_record(record, cfg, device)
        with _stage(stats, "segment"):
            samples, indices = _windows(rec, cfg)
        if len(samples) == 0:
            res = _empty(cid)
            _save_case(cache_dir, cid, res, stats)
            results.append(res)
            continue
        pending.append((cid, samples, indices))
        n_windows += len(samples)
        if n_windows >= windows_per_batch:
            flush()
            n_windows = 0
    flush()
    return results


def _take(q: "deque[np.ndarray]", need: int) -> np.ndarray:
    """Pop exactly ``need`` rows off the front of a deque of arrays."""
    parts = []
    while need:
        a = q[0]
        if len(a) <= need:
            parts.append(a)
            need -= len(a)
            q.popleft()
        else:
            parts.append(a[:need])
            q[0] = a[need:]
            need = 0
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


_PREP_CHUNK = 32  # records filtered together by the producer
_INFLIGHT = 2  # chunks issued and not yet pulled


def _extract_cases_batched_device(case_ids, record_loader, cfg: ExtractionConfig, cache_dir, progress,
                                  windows_per_batch: int, device, stats: Optional[ExtractionStats],
                                  mesh: Optional[Grid] = None) -> List[CaseResult]:
    """Streaming device extraction.  A producer thread loads, filters,
    segments and z-scores records (``_PREP_CHUNK`` at a time) into a
    bounded queue; the main thread cuts the windows into chunks of exactly
    ``windows_per_batch`` (the last one shorter, never padded), issues one
    pass a chunk (``_window_pass`` at ``K_LIGHT`` beats, with the candidate
    buffer chosen from the chunk on the host), and keeps up to
    ``_INFLIGHT`` chunks issued and not pulled, so the host's
    preparation and issue overlap the device's work.  A pulled chunk whose
    peak counts exceed ``K_LIGHT`` is re-run at the full width.  Results
    come back in ``case_ids`` order.  With ``mesh`` each rank passes its
    block of every chunk (``windows_per_batch`` must divide evenly over the
    grid's data axis) and the pulled blocks are gathered; a re-run is
    decided on the whole chunk."""
    W = windows_per_batch
    if mesh is not None and W % mesh.data:
        raise ValueError(f"windows_per_batch={W} must divide evenly over the grid's data axis ({mesh.data} ranks)")
    # every rank must see the same cache hits: read before any rank writes
    cached = {cid for cid in case_ids if os.path.exists(_cache_path(cache_dir, cid) or "")}
    if mesh is not None:
        dist.barrier()
    save_dir = cache_dir if mesh is None or mesh.rank == 0 else None
    by_cid: Dict[int, CaseResult] = {}
    case_meta: "deque[tuple]" = deque()  # (cid, n_windows, indices) in window order
    buf: "deque[np.ndarray]" = deque()  # float32 windows awaiting a chunk
    buf_n = 0
    inflight: "deque[tuple]" = deque()  # (rows, packed on the device, chunk, slots)
    avail: "deque[np.ndarray]" = deque()  # pulled rows awaiting their cases
    avail_n = 0

    def window_pass(x: torch.Tensor, slots: int, k_width: Optional[int]) -> torch.Tensor:
        if len(x) == 0:  # a rank's empty block of a short last chunk
            return torch.zeros((0, _NPEAKS + 1), device=x.device)
        return _window_pass(x, cfg, slots, k_width, stats, True)[0]

    def pulled(packed: torch.Tensor) -> np.ndarray:
        with _stage(stats, "pull"):
            arr = packed.cpu().numpy()
            return arr if mesh is None else np.concatenate(gather_blocks(arr, mesh))

    def issue(chunk: np.ndarray) -> None:
        slots = _candidate_slots(chunk)  # the whole chunk's, on every rank
        with _stage(stats, "upload", device):
            x = torch.from_numpy(chunk if mesh is None else chunk[mesh.rows(len(chunk))]).to(device)
        inflight.append((len(chunk), window_pass(x, slots, K_LIGHT), x, slots))

    def pull(depth: int) -> None:
        nonlocal avail_n
        while len(inflight) > depth:
            k, packed, x, slots = inflight.popleft()
            arr = pulled(packed)
            _count(stats, syncs=1)
            if arr[:, _NPEAKS].max(initial=0.0) > K_LIGHT:
                arr = pulled(window_pass(x, slots, None))
                _count(stats, syncs=1, reruns=1)
            avail.append(arr)
            avail_n += k
            consume()

    def consume() -> None:
        nonlocal avail_n
        while case_meta and case_meta[0][1] <= avail_n:
            cid, n, indices = case_meta.popleft()
            packed = _take(avail, n)
            avail_n -= n
            keep = packed[:, _KEEP] > 0.5
            kp = packed[keep]
            valid = kp[:, _VALID] > 0.5
            res = CaseResult(cid, kp[valid, _WAVES].astype(np.float32), kp[valid, _FEATS].astype(np.float64),
                             indices[keep][valid], n)
            _save_case(save_dir, cid, res, stats)
            by_cid[cid] = res

    q: "queue.Queue[tuple]" = queue.Queue(maxsize=64)
    stop = threading.Event()  # set when the consumer fails: the producer must not block in put forever

    class _Abort(Exception):
        pass

    def put(item: tuple) -> None:
        while True:
            if stop.is_set():
                raise _Abort
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def producer() -> None:
        prep: List[tuple] = []  # (cid, raw record)

        # the producer's device work (filter_backend="device") runs on a
        # stream of its own, beside the chunk passes
        side = torch.cuda.Stream(device) if device.type == "cuda" else None

        def drain() -> None:
            if not prep:
                return
            with _stage(stats, "filter"), (torch.cuda.stream(side) if side else contextlib.nullcontext()):
                recs = preprocess_records_batched([r for _, r in prep], cfg, device)
            for (cid, _), rec in zip(prep, recs):
                with _stage(stats, "segment"):
                    samples, indices = _windows(rec, cfg)
                if len(samples) == 0:
                    res = _empty(cid)
                    _save_case(save_dir, cid, res, stats)
                    put(("ready", cid, res))
                else:
                    put(("case", cid, np.ascontiguousarray(samples, np.float32), indices))
            prep.clear()

        try:
            for cid in _progress(case_ids, progress):
                if cid in cached:
                    put(("ready", cid, _load_case(_cache_path(cache_dir, cid), cid)))
                    continue
                record = record_loader(cid)
                if record is None:
                    continue
                prep.append((cid, record))
                if len(prep) >= _PREP_CHUNK:
                    drain()
            drain()
        except _Abort:
            return  # the consumer failed; its exception is the one raised
        except BaseException as e:  # handed to the consumer, which raises it
            with contextlib.suppress(_Abort):
                put(("error", e))
            return
        with contextlib.suppress(_Abort):
            put(("end",))

    t = threading.Thread(target=producer, name="extract-prep", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item[0] == "end":
                break
            if item[0] == "error":
                raise item[1]
            if item[0] == "ready":
                by_cid[item[1]] = item[2]
                continue
            _, cid, samples, indices = item
            case_meta.append((cid, len(samples), indices))
            buf.append(samples)
            buf_n += len(samples)
            while buf_n >= W:
                issue(_take(buf, W))
                buf_n -= W
                pull(_INFLIGHT)
        if buf_n:
            issue(_take(buf, buf_n))
            buf_n = 0
        pull(0)
    finally:
        stop.set()
        t.join(timeout=60.0)
    return [by_cid[cid] for cid in case_ids if cid in by_cid]
