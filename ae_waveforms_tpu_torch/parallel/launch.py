"""One process per device on ``torch.distributed`` (no counterpart in the
JAX package, whose device mesh lives in one process).

``run(fn, args, devices, backend, timeout_s)`` starts one rank a device
(``torch.multiprocessing``'s spawn, so a rank imports the package afresh
and never ``jax``).  Rank r pins ``devices[r]`` (``torch.cuda.set_device``
before any CUDA work; one CPU thread on the CPU, where ranks share the
host's cores), joins the group through a file rendezvous in a temporary
directory of its own (no port, so runs side by side never collide), calls
``fn(device, *args)`` and destroys the group, also when ``fn`` raised.  The
parent returns rank 0's result.  A rank that raises fails the parent with
its traceback (the others are stopped); past ``timeout_s`` the parent kills
every rank and raises ``TimeoutError``, so a hung collective fails one call
instead of hanging its caller.  ``timeout_s`` None (the CLIs' runs, whose
ranks may wait long at a collective, say for another rank's configs to
finish training) sets no deadline and a collective timeout of 30 days.

``fn`` must be a module-level function (spawn pickles it by name) and its
arguments and result picklable; they travel through files in the run's
temporary directory, not the spawn pipe, so a rank that dies while it
starts (say, spawn cannot re-import a ``__main__`` read from stdin: run
such a script from a file or ``python -c``) fails the parent at once.
NCCL is the backend on CUDA devices, gloo on the CPU (``devices_for``);
gloo also runs several ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["run", "devices_for"]


def devices_for(n_devices: int, device=None) -> Tuple[List[str], str]:
    """The devices and backend of ``n_devices`` ranks: ``cuda:0`` to
    ``cuda:{n-1}`` over NCCL, or n CPU ranks over gloo when ``device`` is
    the CPU.  ``n_devices`` 0 means every visible device (one on the CPU).
    Asking for more CUDA devices than are visible raises ``SystemExit``
    naming the count: there is no fallback to the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * max(n_devices, 1), "gloo"
    count = torch.cuda.device_count()
    n = n_devices or count
    if n < 1 or n > count:
        raise SystemExit(f"--n_devices {n_devices}: {count} CUDA devices are visible; pass --device cpu to run "
                         f"{n_devices or 1} ranks on the CPU")
    return [f"cuda:{i}" for i in range(n)], "nccl"


def _rank(rank: int, tmp: str, devices: List[str], backend: str, timeout_s: Optional[float]) -> None:
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:  # written by the parent of this call
        fn, args = pickle.load(f)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank,
                            world_size=len(devices),
                            timeout=timedelta(days=30) if timeout_s is None else timedelta(seconds=timeout_s))
    try:
        out = fn(device, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run(fn: Callable, args: Sequence = (), devices: Sequence[str] = ("cpu",), backend: str = "gloo",
        timeout_s: Optional[float] = 600.0) -> Any:
    """``fn(device, *args)`` on one rank a device; returns rank 0's result
    (see the module docstring)."""
    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="ae_ranks_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = torch.multiprocessing.start_processes(_rank, args=(tmp, devices, backend, timeout_s),
                                                    nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0 if deadline is None else max(0.0, min(1.0, deadline - time.monotonic()))):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{len(devices)} ranks of {getattr(fn, '__name__', fn)} still running "
                                       f"after {timeout_s} s; killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:  # written by rank 0 of this call
            return pickle.load(f)
