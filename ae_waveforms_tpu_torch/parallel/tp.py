"""Tensor-parallel layer pair over the grid's model axis (the port of the
JAX package's ``parallel/tp.py``).

The production models are small enough that data parallelism is all they
need (see ``mesh.py``), so this is the capability the 2-D grid offers: a
Megatron-style column-parallel -> row-parallel dense pair with the one
all-reduce the pattern needs, numerically the unsharded MLP.

- Column-parallel first layer: each model rank holds W1[:, cols] and b1[cols]
  and computes its slice of the hidden activations; no communication.
- Row-parallel second layer: each model rank holds W2[cols, :] and adds its
  partial product; one all-reduce SUM over the model group completes the
  product, and the replicated b2 is added after it.
- The batch stays split over the data axis: a rank computes its data
  block's rows.

The all-reduce is a ``torch.autograd.Function`` whose backward is the
identity: every model rank needs the whole output's gradient for its own
shard.  (``torch.distributed.nn.functional.all_reduce`` all-reduces the
gradient too, which would scale W1's and W2's gradients by the model
group's size.)
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ae_waveforms_tpu_torch.parallel.mesh import Grid, all_reduce_sum_, block

__all__ = ["shard_mlp_params", "mlp_forward_tp", "tp_train_step"]


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def shard_mlp_params(params: Dict, grid: Grid, device=None) -> Dict[str, torch.Tensor]:
    """This rank's share of a 2-layer MLP's params {w1 (d_in, H), b1 (H,),
    w2 (H, d_out), b2 (d_out,)} (arrays or tensors): the hidden axis split
    over the model axis (``mesh.block``), b2 replicated; float32 tensors on
    ``device``."""
    cols = block(params["w1"].shape[1], grid.model, grid.model_index)
    put = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()  # noqa: E731
    return {"w1": put(params["w1"])[:, cols].contiguous(), "b1": put(params["b1"])[cols].contiguous(),
            "w2": put(params["w2"])[cols].contiguous(), "b2": put(params["b2"])}


def mlp_forward_tp(params: Dict[str, torch.Tensor], x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """relu(x W1 + b1) W2 + b2 of this rank's data block of the batch ``x``
    (every rank passes the whole batch); returns that block's rows."""
    xb = x[grid.rows(x.shape[0])]
    part = torch.relu(xb @ params["w1"] + params["b1"]) @ params["w2"]
    return _SumOverGroup.apply(part, grid.model_group) + params["b2"]


def tp_train_step(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor, lr: float, grid: Grid):
    """One SGD step on the batch (``x`` (n, d_in), ``y`` (n,), the whole
    batch on every rank) of mean((f(x)[:, 0] - y)^2).  Each rank's
    gradients are those of its shard, summed over the data axis against the
    global mean.  Returns (this rank's new shard, the batch's loss)."""
    rows = grid.rows(x.shape[0])
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    part = torch.square(mlp_forward_tp(p, x, grid)[:, 0] - y[rows]).sum() / x.shape[0]
    part.backward()
    grads = [p[k].grad for k in p]
    loss = part.detach().reshape(1)
    all_reduce_sum_([*grads, loss], grid.data_group)
    with torch.no_grad():
        new = {k: p[k].detach() - lr * p[k].grad for k in p}
    return new, float(loss)
