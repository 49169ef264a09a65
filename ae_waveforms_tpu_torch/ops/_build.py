"""Build the hand-written kernels and load them with ctypes.

Each CUDA source in ``csrc/`` exposes a plain ``extern "C"`` launcher, so it
compiles with ``nvcc`` in seconds without PyTorch's headers; the host
delineator (``csrc/delineate.cpp``) compiles with ``g++``.  A library is
named after its source's content hash and flags (and, for host C++ built
for the host's own instruction set, the host's name) and built on first use
into ``build/torch_kernels`` at the checkout's root; nothing is compiled at
import.  ``--use_fast_math`` is deliberately absent: ``__expf`` and
``tanh.approx`` would cost the encoder's 2e-5 tolerance; ``g++`` runs with
``-ffp-contract=off`` so that no multiply-add is fused and the delineator
stays index-exact against the float64 Python one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "HOST_SOURCES", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = {"lstm_encoder": "lstm_encoder.cu", "gbt_route": "gbt_route.cu", "gbt_hist": "gbt_hist.cu",
           "gbt_split": "gbt_split.cu", "gbt_tree": "gbt_tree.cu"}
#: host C++ built with g++: the float64 delineator of the ``host`` engine
HOST_SOURCES = {"delineate": "delineate.cpp"}
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-ffp-contract=off"]
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


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host delineator (engine='host') is built with a C++ compiler; "
                           "engine='python' runs the pure-Python delineator")
    return gxx


def _source(name: str) -> Path:
    return CSRC / (KERNELS[name] if name in KERNELS else HOST_SOURCES[name])


def _flags(name: str):
    return NVCC_FLAGS if name in KERNELS else GXX_FLAGS


def _library(name: str) -> Path:
    key = " ".join(_flags(name)) + ("" if name in KERNELS else f" {platform.node()} {platform.machine()}")
    digest = hashlib.sha256(_source(name).read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(KERNELS) + tuple(HOST_SOURCES)) -> None:
    """Compile the named libraries that are not built yet, one compiler
    process per source, all started together.  Each compiler's output
    (``nvcc``'s resource report, ``-Xptxas -v``) is kept in ``<name>.log``."""
    todo = [n for n in names if not _library(n).is_file()]
    if not todo:
        return
    compilers = {n: _nvcc() if n in KERNELS else _gxx() for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _library(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compilers[n], *_flags(n), "-o", str(tmp), str(_source(n))]
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
        raise RuntimeError(f"the build failed for {failed}:\n{logs}")


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a CUDA kernel or host source), built first if
    needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_library(name)))
    return _loaded[name]
