"""Logging and experiment tracking (a copy of the JAX package's
``train/logs.py``: pure Python).

Three channels, mirroring the reference's observability
(run_train.py:305-336, :417-431):

- python logging with an ANSI console handler + ``console.log`` file;
- CSV artifacts: ``training_log.csv`` (every 10 steps) and
  ``training_log_validation.csv`` (one row per validation);
- a pluggable tracker.  Neptune is not assumed to exist; the built-in
  ``JsonlTracker`` appends scalar streams to ``run.jsonl`` in the results
  dir with the same stream names the reference pushes to Neptune
  ("Train Loss", "Batch number", "Learning Rate", "Validation loss",
  "epoch").  A Neptune adapter can be registered without touching the loop.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Optional

__all__ = ["setup_logging", "CsvLogs", "JsonlTracker", "make_tracker"]


def setup_logging(results_dir: str) -> logging.Logger:
    os.makedirs(results_dir, exist_ok=True)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s  %(levelname)-8s  %(name)-28s \t| %(message)s",
        datefmt="%H:%M:%S",
        filename=os.path.join(results_dir, "console.log"),
        filemode="w+",
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(
        logging.Formatter(
            "\033[0;37m%(asctime)s  %(levelname)-8s  %(name)-28s \t\033[0;2m| %(message)s\033[0m",
            datefmt="%H:%M:%S",
        )
    )
    root.addHandler(console)
    logging.getLogger("jax").setLevel(logging.WARNING)  # keep console.log readable where JAX shares the process
    return logging.getLogger("train")


class CsvLogs:
    """training_log.csv / training_log_validation.csv writers; with
    ``results_dir`` None (a rank that writes no files) they write nothing."""

    def __init__(self, results_dir: Optional[str]):
        self.dir = results_dir
        self._train_rows = []

    def train_step(self, epoch: int, step: int, lr: float, loss: float) -> None:
        # every-10-steps cadence handled by the caller, like the reference
        self._train_rows.append([epoch, step, lr, loss])

    def flush_train(self) -> None:
        if not self._train_rows or self.dir is None:
            self._train_rows.clear()
            return
        with open(os.path.join(self.dir, "training_log.csv"), "a", newline="") as f:
            csv.writer(f).writerows(self._train_rows)
        self._train_rows.clear()

    def validation(self, epoch: int, step: int, lr: float, train_loss: float, val_loss: float) -> None:
        self.flush_train()
        if self.dir is None:
            return
        with open(os.path.join(self.dir, "training_log_validation.csv"), "a", newline="") as f:
            csv.writer(f).writerow([epoch, step, lr, train_loss, val_loss])

    def close(self) -> None:
        """Flush buffered train rows; REQUIRED at end-of-run — without it,
        up to validation_interval - 1 trailing rows after the last
        validation would be dropped (the reference writes every 10 steps
        unconditionally, run_train.py:305-309)."""
        self.flush_train()


class JsonlTracker:
    """Append-only scalar stream tracker (Neptune-capability stand-in).

    Writes are buffered (flushed every ``flush_every`` records) so per-step
    logging of a 228k-step run stays off the training loop's critical path.
    """

    def __init__(self, results_dir: str, tags=None, flush_every: int = 512):
        self.path = os.path.join(results_dir, "run.jsonl")
        self._f = open(self.path, "a")
        self._buf = []
        self._flush_every = flush_every
        if tags:
            self.log("tags", tags)

    def log(self, stream: str, value) -> None:
        self._buf.append(json.dumps({"t": time.time(), "stream": stream, "value": value}))
        if len(self._buf) >= self._flush_every:
            self._drain()

    def _drain(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()

    def close(self) -> None:
        self._drain()
        self._f.flush()
        self._f.close()


class _NoopTracker:
    def log(self, stream, value):
        pass

    def close(self):
        pass


class NeptuneTracker:
    """Adapter for the reference's Neptune channel — used only when the
    neptune client is importable and credentials are configured
    (run_train.py:394-407 capability; optional in this framework)."""

    def __init__(self, results_dir: str, tags=None):
        import neptune  # gated optional dependency

        self.run = neptune.init_run(
            project=os.environ.get("NPT_PROJECT"),
            api_token=os.environ.get("NPT_API_TOKEN"),
            tags=[str(t) for t in (tags or [])],
        )

    def log(self, stream: str, value) -> None:
        self.run[stream].append(value)

    def close(self) -> None:
        self.run.stop()


def make_tracker(kind: Optional[str], results_dir: str, tags=None):
    if kind in (None, "none", False):
        return _NoopTracker()
    if kind in ("jsonl", "csv", True):
        return JsonlTracker(results_dir, tags)
    if kind == "neptune":
        try:
            return NeptuneTracker(results_dir, tags)
        except ImportError:
            logging.getLogger("tracker").warning("neptune unavailable; falling back to jsonl")
            return JsonlTracker(results_dir, tags)
    raise ValueError(f"unknown tracker {kind!r}")
