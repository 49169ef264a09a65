"""Typed extraction and training/testing configuration (copies of the JAX
package's ``ExtractionConfig`` and ``TrainConfig``; all reference defaults
are preserved).

Pure Python: the port keeps its own copy so that it imports nothing of the
JAX package.  As the JAX module does, importing this one loads ``vars.env``
from the working directory into the environment (variables already set
win), so ``DATA_FOLDER_PATH`` there sets the default data directory of
both packages alike.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ExtractionConfig", "TrainConfig", "default_extraction_config", "load_env_file"]


def load_env_file(path: str = "vars.env", override: bool = False) -> dict:
    """Load KEY=VALUE pairs from an env file into os.environ (the reference's
    dotenv-based vars.env contract, config.py:6-12, without requiring the
    python-dotenv package).  Returns the parsed mapping."""
    values = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                values[k.strip()] = v.strip()
                if override or k.strip() not in os.environ:
                    os.environ[k.strip()] = v.strip()
    return values


load_env_file()  # opportunistic, like the reference's module-import load


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass(frozen=True)
class ExtractionConfig:
    """Signal-extraction parameters (reference: config.py:17-33)."""

    path_data: str = field(default_factory=lambda: _env("DATA_FOLDER_PATH", "./data"))
    track_names: Tuple[str, ...] = ("SNUADC/ECG_II",)
    sampling_frequency: int = 500  # Hz
    # HRV (RMSSD) threshold above which a sample is believed to contain PVCs.
    pvc_threshold: float = 150.0
    # std(sample)/n_peaks ratio threshold (reference default 0.05; the README's
    # quoted 0.0335 is stale — remove_samples.py:8).
    sd_threshold_ecg: float = 0.05
    butter_order: int = 4
    butter_hp_ecg: float = 1.0  # Hz, 0 disables
    butter_lp_ecg: float = 30.0  # Hz, 0 disables
    sample_length: int = 20  # seconds per window
    hr_min: float = 30.0  # bpm
    hr_max: float = 180.0  # bpm
    # prefetch records on a background thread (the reference's mp.Pool
    # preprocessing fan-out, data_extract_vitaldb.py:194-199)
    parallel_preprocessing: bool = False
    use_pickle: bool = True

    # knobs of the JAX package (no reference counterpart)
    precision: str = "float32"  # "float32" | "float64" (parity-check mode)
    # "host": float64 per-window delineation by the C++ delineator
    # (csrc/delineate.cpp, index-exact against "python"); "python": the
    # pure-Python float64 delineator; "device": the batched float32
    # delineator on the device (signals/delineate_device.py)
    delineation_engine: str = "host"
    # analysis-rate (500 -> 2000 Hz) resampler used by delineation
    # (signals/delineate.py RESAMPLE_METHODS).  "linear" is the contract of
    # all three engines; "fft"/"poly" are python-engine-only probes
    delineation_resample: str = "linear"
    # record filter ("host" | "device"): "host" runs the reference's scipy
    # filtfilt chain in float64 math (cast to the working precision);
    # "device" the batched float32 filtfilt on the device
    # (signals/filters.py: butterworth_batched, filtfilt_fixed)
    filter_backend: str = "host"
    max_peaks_per_sample: int = 96  # fixed-shape padded peak buffer (20s @ 180bpm -> 60)
    max_qrs_segments: int = 256  # fixed-shape QRS-candidate buffer

    @property
    def wave_sample_length(self) -> int:
        return int(self.sampling_frequency * self.sample_length)

    @property
    def beat_length(self) -> int:
        # 0.8 * (60/75) s slice per beat -> 320 samples @ 500 Hz
        # (reference: median_sample.py:20-22, data_create_arrays.py:17-18)
        return int(0.8 * (60.0 / 75.0) * self.sampling_frequency)

    @property
    def pre_r_length(self) -> int:
        # 1/3 before the R peak (reference: median_sample.py:24)
        return int(self.beat_length / 3)

    @property
    def post_r_length(self) -> int:
        return self.beat_length - self.pre_r_length


def default_extraction_config() -> ExtractionConfig:
    return ExtractionConfig()


@dataclass(frozen=True)
class TrainConfig:
    """AE training/testing flags (reference: main_ae.py:15-126 defaults)."""

    mode: str = "train"
    dataset_dir: str = field(default_factory=lambda: _env("DATA_FOLDER_PATH", "./data"))
    results_dir: str = "./results"
    seed: int = 1
    model_class: str = "LSTMAutoencoder"
    latent_size: int = 10
    split_size_val: float = 0.02
    split_size_test: float = 0.01
    nr_train_ids: int = 0
    batch_size: int = 128
    epochs: int = 10
    validation_interval: int = 200
    early_stopping_patience: int = 2000
    loss: str = "mse"  # mae (SmoothL1) | mse | rmse
    weight_decay: float = 0.0
    dropout: float = 0.2
    lr: float = 1e-3
    lr_scheduler_type: str = "StepLR"  # StepLR | CosineAnnealing | CosineAnnealingWarmup
    lr_scheduler_val_delay: int = 0
    lr_scheduler_caw_settings: Tuple[float, float, float] = (0.02, 10, 1e-5)
    optimizer_type: str = "adam"  # adam|adagrad|adadelta|sgd|ranger|rmsprop
    sgd_momentum: float = 0.9
    ranger_momentum: float = 0.95
    ranger_threshold: int = 5
    train_shuffle: bool = True
    val_shuffle: bool = False
    trained_model: str = "AUT-231"
    plotting: bool = True
    # target training-sample count used to rescale epochs when subsampling
    # case ids (reference: run_train.py:472 magic constant)
    target_train_samples: int = 228543

    # knobs of the JAX package, kept so that configs carry across unchanged
    data_axis: str = "data"
    n_devices: int = 0
    model_parallel: int = 1
    compute_dtype: str = "default"
    tracker: Optional[str] = None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
