"""The device grid and its splits (the port of the JAX package's
``parallel/mesh.py``).

The workload's only meaningful parallel axis is the batch (or the seeds,
configs or windows of a study): the models are ~0.3M parameters.  A JAX mesh
holds every device in one process; the port runs one process per device
(``parallel/launch.py``), so its grid is the ranks of the default process
group laid out as (data, model), rank = d * model + m, with the process
groups of its two axes:

- ``data_group``: the ranks of one model column (every data index at this
  rank's model index).  A batch, or a study's seeds, configs or windows,
  is split over it in contiguous blocks (``block``, uneven blocks
  allowed), and gradients are summed over it.
- ``model_group``: the ranks of one data row.  ``parallel/tp.py``'s pair
  sums its partial products over it; everything else is replicated over
  it, as the JAX package replicates over 'model'.

Every rank builds every group, in the same order (``new_group`` is
collective).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Grid", "data_mesh", "block", "gather_blocks", "broadcast_object", "all_reduce_sum_", "pad_to_multiple"]


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, model) grid of ranks."""

    data: int
    model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def rows(self, n: int) -> slice:
        """This rank's block of n rows split over the data axis."""
        return block(n, self.data, self.data_index)


def data_mesh(model_parallel: int = 1) -> Grid:
    """The (world / model_parallel, model_parallel) grid of the default
    process group, which must be initialised (``parallel.launch.run``)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the {world} ranks")
    D, M = world // model_parallel, model_parallel
    data_group = model_group = None
    for m in range(M):
        g = dist.new_group([d * M + m for d in range(D)])
        if rank % M == m:
            data_group = g
    for d in range(D):
        g = dist.new_group([d * M + m for m in range(M)])
        if rank // M == d:
            model_group = g
    return Grid(D, M, rank, data_group, model_group)


def block(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``parts`` contiguous blocks of n rows; the first
    ``n % parts`` blocks take one row more (``np.array_split``'s cut)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (index < extra))


def gather_blocks(part, grid: Grid) -> List:
    """Every data index's ``part`` (picklable), in data-index order, on
    every rank of this rank's data group."""
    out: List = [None] * grid.data
    dist.all_gather_object(out, part, group=grid.data_group)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` in place, through one all-reduce of
    one flat buffer (the tensors share a device and dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis to a multiple (for even batch sharding); returns (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge"), n
