"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` exposes a plain ``extern "C"`` launcher, so it
compiles in seconds without PyTorch's headers.  A library is named after
its source's content hash and built on first use into ``build/torch_kernels``
at the checkout's root; nothing is compiled at import.  ``--use_fast_math``
is deliberately absent: ``__expf`` and ``tanh.approx`` would cost the
encoder's 2e-5 tolerance.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = {"lstm_encoder": "lstm_encoder.cu", "gbt_route": "gbt_route.cu", "gbt_hist": "gbt_hist.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def _library(name: str) -> Path:
    src = CSRC / KERNELS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> None:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  ``nvcc``'s resource report
    (``-Xptxas -v``) is kept in ``<name>.log``."""
    todo = [n for n in names if not _library(n).is_file()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _library(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n])]
        log = open(BUILD_DIR / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for n, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(n)
        else:
            os.replace(tmp, _library(n))
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_library(name)))
    return _loaded[name]
