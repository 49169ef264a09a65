"""What the profiles in this folder and ``chip_smoke.py`` share: variants
of a kernel source as text (``sub``; ``ops._build.build_variants`` builds
them), the registers ``nvcc`` reports for a build, timing on the card
(``graph_ms``, ``event_ms``) and the routing kernel's inputs
(``route_inputs``, ``heap_inputs``).  Each timing function takes the
``torch`` module, as ``chip_smoke.py``'s phases do.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def sub(src: str, old: str, new: str, count: int = 1) -> str:
    """``src`` with ``old`` replaced by ``new``; raises where ``old`` is not
    found exactly ``count`` times, so a changed kernel source fails loudly."""
    if src.count(old) != count:
        raise RuntimeError(f"the kernel source changed; {old!r} found {src.count(old)} times, not {count}")
    return src.replace(old, new)


def registers(out_dir: Path, name: str) -> list:
    """Registers per thread of each kernel instance of build ``name`` in
    ``out_dir``, from ``nvcc``'s resource report (``-Xptxas -v``)."""
    return re.findall(r"Used (\d+) registers", (out_dir / f"{name}.log").read_text())


def graph_ms(torch, fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed and timed with CUDA events, so the host's launch
    gaps between the calls are not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return event_ms(torch, graph.replay, 3) / reps


def event_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around ``reps``
    back-to-back calls after a warm one; includes the gaps in which the card
    waits for the host to launch the next kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _values(rng, size, n_bins, edges):
    """Bins or thresholds: uniform below ``n_bins``, or drawn from ``edges``."""
    return (rng.integers(0, n_bins, size=size) if edges is None else rng.choice(edges, size=size)).astype(np.int32)


def route_inputs(torch, dev, rng, S, n, n_nodes, F=10, n_bins=64, edges=None):
    """One level's arguments of ``route_rows``: an (F, n) pool, node ids
    uniform over the level and S random tables of ``n_nodes`` splits."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(_values(rng, (F, n), n_bins, edges)),
            t(rng.integers(0, n_nodes, size=(S, n)).astype(np.int32)),
            t(rng.integers(0, F, size=(S, n_nodes)).astype(np.int32)),
            t(_values(rng, (S, n_nodes), n_bins, edges)),
            t(rng.random((S, n_nodes)) < 0.7))


def heap_inputs(torch, dev, rng, S, n, d0, d1, F=10, n_bins=64, edges=None):
    """The pool as a predict call passes it, ``bins.T`` of (n, F) bins, level
    d0's node ids (None from the root) and S random heaps of depth d1."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    M = 2**d1
    is_split = rng.random((S, M)) < 0.8
    is_split[:, -1] = False  # the heap's inert slot
    return (t(_values(rng, (n, F), n_bins, edges)).T,
            None if d0 == 0 else t(rng.integers(0, 2**d0, size=(S, n)).astype(np.int32)),
            t(rng.integers(0, F, size=(S, M)).astype(np.int32)),
            t(_values(rng, (S, M), n_bins, edges)),
            t(is_split), d0, d1)
