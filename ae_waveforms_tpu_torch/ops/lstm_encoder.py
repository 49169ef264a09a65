"""Fused stacked-LSTM encoder: a CUDA kernel for Hopper and its plain version.

The port of ``ae_waveforms_tpu/ops/lstm_pallas.py::encode_fused``: the
LSTM-AE encoder (1 -> H1 -> H2 -> latent, torch gate order, summed biases,
zero initial state) as one kernel over all T steps, returning the last
hidden state of layer 3.  The kernel is ``csrc/lstm_encoder.cu``: clusters
of 8 blocks that hold the weights in shared memory, the three layers skewed
so that one cluster barrier serves each time step; its source note says
what bounds it and how it is laid out.  ``encoder_plan`` chooses the rows
per cluster, the number of clusters and the shared memory of a block.

``encode_fused`` launches the kernel for CUDA tensors and runs
``encode_fused_reference`` for CPU tensors; nothing falls back from one to
the other.  Both agree to 2e-5 (float32, sums in another order).  The
kernel has no backward (nor has the JAX package's: training runs the
encoder as LSTM layers), so on a CUDA tensor ``encode_fused`` refuses to
run where autograd would want a graph through it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from ae_waveforms_tpu_torch.models.layers import lstm_cell
from ae_waveforms_tpu_torch.ops import _build

__all__ = ["EncoderPlan", "encode_fused", "encode_fused_reference", "encoder_plan", "max_active_clusters"]


def encode_fused_reference(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a per-step loop of ``lstm_cell`` over the
    three stacked layers.  params: the lstm_ae tree (``enc1``..``enc3``);
    x: (B, T, 1) -> (B, latent)."""
    p1, p2, p3 = params["enc1"], params["enc2"], params["enc3"]
    B, T, _ = x.shape
    gx1 = x @ p1["w_ih"].T + (p1["b_ih"] + p1["b_hh"])  # (B, T, 4*H1)
    w_hh_t = [p["w_hh"].T for p in (p1, p2, p3)]
    w_ih2_t, b2 = p2["w_ih"].T, p2["b_ih"] + p2["b_hh"]
    w_ih3_t, b3 = p3["w_ih"].T, p3["b_ih"] + p3["b_hh"]
    h1, h2, h3 = (x.new_zeros((B, p["w_hh"].shape[1])) for p in (p1, p2, p3))
    c1, c2, c3 = h1, h2, h3
    for t in range(T):
        h1, c1 = lstm_cell(gx1[:, t], h1, c1, w_hh_t[0])
        h2, c2 = lstm_cell(h1 @ w_ih2_t + b2, h2, c2, w_hh_t[1])
        h3, c3 = lstm_cell(h2 @ w_ih3_t + b3, h3, c3, w_hh_t[2])
    return h3


# The launch plan.  A cluster of CLUSTER blocks carries R batch rows.  The
# H100 holds 15 clusters of 8 of this kernel's blocks at once
# (cudaOccupancyMaxActiveClusters, printed by chip_smoke.py), so the plan
# keeps the grid to MAX_CLUSTERS clusters, one wave, wherever R <= 32
# allows it (B <= 480).  SMEM_BUDGET is the shared memory one block may use
# on the H100 (227 KB); the kernel checks the bytes it is given against its
# own layout, which _smem_floats mirrors.
CLUSTER = 8
MAX_CLUSTERS = 15
ROWS_PER_CLUSTER = (1, 2, 4, 8, 16, 32)  # the kernel's instances
SMEM_BUDGET = 232_448
_SPLIT, _UNITS = 16, 2  # lanes per unit, units per warp (kSplit, kUnits in the kernel)


class EncoderPlan(NamedTuple):
    rows_per_cluster: int
    clusters: int
    smem_bytes: int


def _smem_floats(R: int, T: int, H1: int, H2: int, L: int) -> int:
    """Floats of one block's shared memory, as ``Layout`` in the kernel
    counts them: both h buffers (16 inputs of padding, R values per input,
    padded by 4 where R / 4 is even), the tile's beats, the cell state, and
    the block's share of the weights and biases in lane order."""
    a4 = lambda n: -(-n // 4) * 4  # noqa: E731
    RP = R if R < 4 or (R // 4) % 2 == 1 else R + 4
    U = [-(-h // CLUSTER) for h in (H1, H2, L)]
    K = [H1, H1 + H2, H2 + L]
    pairs = [-(-u // _UNITS) for u in U]
    weights = sum(p * (-(-k // _SPLIT) * 128 + 4 * _UNITS) for p, k in zip(pairs, K)) + pairs[0] * 4 * _UNITS
    return a4(2 * (H1 + H2 + L + _SPLIT) * RP) + a4(R * T) + a4(sum(U) * R) + weights


def encoder_plan(B: int, H1: int, H2: int, L: int, T: int = 320) -> EncoderPlan:
    """Rows per cluster, clusters and shared-memory bytes per block for a
    batch of B sequences of T steps through 1 -> H1 -> H2 -> L.

    R is the least of ``ROWS_PER_CLUSTER`` that keeps the grid within 15
    clusters (32 past B = 480).  Raises ValueError when a block's share
    does not fit its shared memory."""
    R = next((r for r in ROWS_PER_CLUSTER if -(-B // r) <= MAX_CLUSTERS), ROWS_PER_CLUSTER[-1])
    smem = 4 * _smem_floats(R, T, H1, H2, L)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"the encoder 1->{H1}->{H2}->{L} at T={T} needs {smem} bytes of shared memory per block "
            f"({R} rows per cluster of {CLUSTER}); a block holds {SMEM_BUDGET}"
        )
    return EncoderPlan(R, -(-B // R), smem)


def max_active_clusters(plan: EncoderPlan, H1: int, H2: int, L: int, T: int = 320) -> int:
    """How many clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    active = ctypes.c_int(0)
    rc = _build.load("lstm_encoder").lstm_encoder_max_active_clusters(T, H1, H2, L, *plan, ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {rc}")
    return active.value


def _check_layer(p: Dict, in_features: int, name: str, dev: torch.device) -> int:
    H = p["w_hh"].shape[1]
    for k, shape in (("w_ih", (4 * H, in_features)), ("w_hh", (4 * H, H)), ("b_ih", (4 * H,)), ("b_hh", (4 * H,))):
        _build.check(f"{name}.{k}", p[k], dev, torch.float32, shape)
    return H


def encode_fused(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """LSTM-AE encoder latent (B, latent) of x (B, T, 1) float32.

    On a CUDA tensor this launches the kernel with the plan of
    ``encoder_plan`` (and counts the launch in ``_build.launches``);
    on a CPU tensor it runs the plain version.  On a CUDA tensor it raises
    when grad is enabled and x or a weight requires grad: the kernel writes
    its output outside autograd, so the latent would carry no gradient."""
    dev = _build.device(x, "encode_fused")
    if x.is_cpu:
        return encode_fused_reference(params, x)
    p1, p2, p3 = params["enc1"], params["enc2"], params["enc3"]
    weights = [p[k] for p in (p1, p2, p3) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    _build.check("x", x, dev, torch.float32, (*x.shape[:2], 1))  # (B, T, 1)
    H1 = _check_layer(p1, 1, "enc1", dev)
    H2 = _check_layer(p2, H1, "enc2", dev)
    L = _check_layer(p3, H2, "enc3", dev)
    B, T, _ = x.shape
    plan = encoder_plan(B, H1, H2, L, T)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        raise RuntimeError(
            "encode_fused has no backward: call it under torch.no_grad(), or train the model in "
            "train() mode, where the encoder runs as LSTM layers"
        )
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _build.launch(_build.load("lstm_encoder").lstm_encoder_launch, dev, x.data_ptr(), *(w.data_ptr() for w in weights),
                  out.data_ptr(), B, T, H1, H2, L, *plan)
    return out
