"""Device-memory model of the stacked multi-config trainers (the port of
the JAX package's ``core/hbm.py``, re-derived for the port's own
implementation on the card).

The JAX package's model is calibrated on a TPU worker's crash cliff; its
constants say nothing about the port.  Here the count follows what the
port's trainers (``train/stacked.py``) hold on the device:

* per config, for the whole run: its parameters, their gradients, the
  optimizer's two moments and the best-snapshot copy (5 float32 copies of
  the parameter count), and the data it holds alone (the DL classifier's
  per-seed train and validation arrays; the AE trainer shares one dataset
  across configs, passed as ``shared_bytes``);
* once, whatever the number of configs: one config's recurrent training
  working set.  Each config's forward and backward run back to back and
  free their graph before the next config's, so the working sets of two
  configs are never alive together.  Per LSTM layer it is the layer's
  output (B, T, H), kept as the next layer's input, and cuDNN's reserve
  space and workspace, ``RESERVE_PER_UNIT`` float32 words per (row, step,
  unit); under ``remat_chunk`` those of one chunk of steps and the (h, c)
  carries at the chunk boundaries instead; plus two (B, T, max H)
  gradient buffers of the backward.  Or, where it is larger, the
  validation pass's over the config's validation rows at once, no graph
  kept: ``EVAL_PER_UNIT`` float32 words per (row, step, unit).

The budget is the device's free memory (``torch.cuda.mem_get_info``) times
``SAFETY``: the rest is left to the caching allocator's rounding, cuDNN's
workspaces and the CUDA context.  ``chip_smoke.py`` prints the measured
peak beside this count.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["train_block_hbm_bytes_per_config", "recurrent_working_set_bytes", "seed_axis_cap", "SAFETY",
           "RESERVE_PER_UNIT", "EVAL_PER_UNIT"]

_F32 = 4
# float32 copies of the parameters a config holds: params, grads, Adam's m and v, the best snapshot
STATE_COPIES = 5
# cuDNN's LSTM training reserve space and workspace in float32 words per (row, step, hidden unit): measured on an
# H100 80GB HBM3 by chip_smoke.py's working-set probe, whose whole step came to 14.6 words a unit for the classifier
# (B = 512) and 14.9 for the autoencoder (B = 128), outputs and backward buffers included
RESERVE_PER_UNIT = 13
# the eval-mode pass (cuDNN's inference workspace and the outputs) in float32 words per (row, step, hidden unit):
# inferred on an H100 80GB HBM3 from chip_smoke.py's 25-seed epoch with remat, whose 1,732 MiB peak less a training
# step's 347 MiB working set and the seeds' 140 MiB left 9.7 words a unit for its 500-row test pass
EVAL_PER_UNIT = 10
SAFETY = 0.8


def train_block_hbm_bytes_per_config(
    n_train: int,
    n_val: int,
    seq_len: int,
    batch: int,
    hidden_sizes: Sequence[int],
    param_count: int,
    remat_chunk: int = 0,
) -> int:
    """Bytes one config holds for the whole run: its parameter-shaped state
    and its own data rows.  ``batch``, ``hidden_sizes`` and ``remat_chunk``
    enter the working set, which is not per config
    (``recurrent_working_set_bytes``); they are kept so that callers read
    as the JAX package's."""
    del batch, hidden_sizes, remat_chunk
    return STATE_COPIES * _F32 * param_count + _F32 * (n_train + n_val) * seq_len


def recurrent_working_set_bytes(seq_len: int, batch: int, hidden_sizes: Sequence[int], remat_chunk: int = 0,
                                n_val: int = 0) -> int:
    """One config's working set of its LSTM layers (module docstring): a
    training step at ``batch`` rows of ``seq_len`` steps, or the validation
    pass over ``n_val`` rows, whichever is larger."""
    steps = min(remat_chunk, seq_len) if remat_chunk and remat_chunk > 0 else seq_len
    bt = batch * seq_len
    outputs = _F32 * bt * sum(hidden_sizes)
    reserve = _F32 * batch * steps * RESERVE_PER_UNIT * sum(hidden_sizes)
    carries = 0
    if remat_chunk and remat_chunk > 0:
        carries = _F32 * batch * 2 * sum(hidden_sizes) * math.ceil(seq_len / remat_chunk)
    backward = 2 * _F32 * bt * max(hidden_sizes)
    return max(outputs + reserve + carries + backward, EVAL_PER_UNIT * _F32 * n_val * seq_len * sum(hidden_sizes))


def seed_axis_cap(
    n_train: int,
    n_val: int,
    seq_len: int,
    batch: int,
    hidden_sizes: Sequence[int],
    param_count: int,
    remat_chunk: int = 0,
    safety: float = SAFETY,
    shared_bytes: int = 0,
    free_bytes: Optional[int] = None,
) -> int:
    """Most configs of this shape that fit the budget at once: ``safety`` x
    the free device memory (``free_bytes``, read from the current CUDA
    device when None), less the configs' shared bytes (``shared_bytes``:
    the AE trainer's one dataset) and one working set, over the bytes a
    config holds.  At least 1."""
    if free_bytes is None:
        import torch

        free_bytes = torch.cuda.mem_get_info()[0]
    b = min(batch, max(n_train, 1)) if n_train else batch
    per = train_block_hbm_bytes_per_config(n_train, n_val, seq_len, b, hidden_sizes, param_count, remat_chunk)
    room = free_bytes * safety - shared_bytes - recurrent_working_set_bytes(seq_len, b, hidden_sizes, remat_chunk,
                                                                            n_val)
    return max(1, int(room // per))
