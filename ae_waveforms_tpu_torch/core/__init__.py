"""The extraction and training configs, the array schema, the memory model
and the FLOP counts."""

from ae_waveforms_tpu_torch.core.config import (
    ExtractionConfig,
    TrainConfig,
    default_extraction_config,
)
from ae_waveforms_tpu_torch.core.schema import ArraySet, load_arrays, save_arrays

__all__ = [
    "ExtractionConfig",
    "TrainConfig",
    "default_extraction_config",
    "ArraySet",
    "load_arrays",
    "save_arrays",
]
