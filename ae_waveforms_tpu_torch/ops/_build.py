"""Build the hand-written kernels, load them with ctypes and launch them.

Each CUDA source in ``csrc/`` exposes plain ``extern "C"`` functions, so it
compiles with ``nvcc`` in seconds without PyTorch's headers; the host
delineator (``csrc/delineate.cpp``) compiles with ``g++``.  A library is
named after its source's content hash and flags (and, for host C++ built
for the host's own instruction set, the host's name) and built on first use
into ``build/torch_kernels`` at the checkout's root; nothing is compiled at
import.  ``--use_fast_math`` is deliberately absent: ``__expf`` and
``tanh.approx`` would cost the encoder's 2e-5 tolerance; ``g++`` runs with
``-ffp-contract=off`` so that no multiply-add is fused and the delineator
stays index-exact against the float64 Python one.

The launch contract of every CUDA kernel lives here:

- the C prototype is the only signature: ``load`` reads a CUDA library's
  ``extern "C"`` prototypes from its source and sets each function's ctypes
  ``argtypes`` and ``restype`` from them (``signatures``, ``bind``);
- a launcher is named ``<kernel>_launch`` and takes the stream last;
  ``launch`` is the one way to call it: it checks the argument count, runs
  on the device's current stream, raises on a non-zero ``cudaError_t`` and
  counts the launch in ``launches`` under ``<kernel>``;
- ``plan`` caches what a launch at a seen key needs besides its tensors (the
  plan and the scalar arguments, ``scalars``), counted in ``plan_hits`` and
  ``plan_misses``;
- ``check`` is the one tensor check (``checks`` runs it over many tensors in
  one pass, ``check_table`` over a table that may be wider than a launch
  reads), ``device`` the one CPU/CUDA dispatch.

A kernel is added by a ``.cu`` file with its ``extern "C"`` launcher and a
wrapper that calls ``check`` and ``launch``; no table here changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["KERNELS", "HOST_SOURCES", "BUILD_DIR", "MAX_PLANS", "bind", "build", "build_variants", "check", "check_table",
           "checks", "device", "launch", "launches", "load", "plan", "plan_hits", "plan_misses", "scalars", "signatures"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: CUDA sources, built with nvcc and bound from their prototypes
KERNELS = {p.stem: p.name for p in sorted(CSRC.glob("*.cu"))}
#: host C++ built with g++: the float64 delineator of the ``host`` engine
HOST_SOURCES = {p.stem: p.name for p in sorted(CSRC.glob("*.cpp"))}
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-ffp-contract=off"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}

# the C types of a prototype: any pointer is a c_void_p
_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "double": ctypes.c_double,
           "cudaStream_t": ctypes.c_void_p, "void": None}
_PROTOTYPE = re.compile(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(\w+)\s*\(([^)]*)\)')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_LAUNCH = "_launch"


def _ctype(decl: str, where: str):
    if "*" in decl:
        return ctypes.c_void_p
    c = " ".join(w for w in decl.split() if w != "const")
    if c not in _CTYPES:
        raise ValueError(f"{where}: no ctypes type for the C type {c!r}")
    return _CTYPES[c]


def signatures(text: str) -> Dict[str, Tuple[Optional[type], List[type]]]:
    """The ``extern "C"`` functions of a CUDA source's text, name ->
    (restype, argtypes): any pointer a ``c_void_p``, ``int`` a ``c_int``,
    ``long long`` a ``c_longlong``, ``double`` a ``c_double``,
    ``cudaStream_t`` a ``c_void_p``.  Raises ValueError on any other type and
    on a launcher (``<kernel>_launch``) whose last parameter is not the
    stream."""
    out = {}
    for result, name, params in _PROTOTYPE.findall(_COMMENT.sub("", text)):
        decls = [p.strip() for p in params.split(",")]
        decls = [] if decls in ([""], ["void"]) else decls
        # a parameter's type is its declaration less its name, unless a pointer
        argtypes = [_ctype(d if "*" in d else d.rsplit(None, 1)[0], name) for d in decls]
        if name.endswith(_LAUNCH) and not (decls and decls[-1].split()[0] == "cudaStream_t"):
            raise ValueError(f"{name}: a launcher takes the cudaStream_t last")
        out[name] = (_ctype(result, name), argtypes)
    return out


def bind(lib, text: str):
    """Set the ctypes signature of each ``extern "C"`` function of ``lib``
    from ``text``, its source; a launcher also gets its kernel's name
    (``kernel``) and its arguments but the stream (``nargs``) for
    ``launch``.  Returns ``lib``."""
    for name, (restype, argtypes) in signatures(text).items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        if name.endswith(_LAUNCH):
            fn.kernel, fn.nargs = name[: -len(_LAUNCH)], len(argtypes) - 1
    return lib


#: kernel launches in this process, by kernel: one key a ``<kernel>_launch``
#: of ``csrc/*.cu``, counted by ``launch``
launches: Dict[str, int] = {name[: -len(_LAUNCH)]: 0 for source in KERNELS.values()
                            for name in signatures((CSRC / source).read_text()) if name.endswith(_LAUNCH)}


def launch(fn, dev: torch.device, *args) -> None:
    """Call the launcher ``fn`` (of a library from ``load`` or
    ``build_variants``) with ``args``, its prototype's parameters but the
    stream, on CUDA device ``dev`` and its current stream, and count it in
    ``launches``.  A wrong number of arguments raises TypeError before the
    call (ctypes passes extra ones silently); a non-zero result raises
    RuntimeError naming the kernel and the ``cudaError_t``.

    ctypes launches on the thread's current device, so ``dev`` is made
    current only where it is not; the stream is read at every call, so a
    stream made current between two launches takes the second."""
    if len(args) != fn.nargs:
        raise TypeError(f"{fn.__name__} takes {fn.nargs} arguments before the stream, got {len(args)}")
    index = dev.index
    if torch._C._cuda_getDevice() == index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.kernel} kernel launch failed: cudaError_t {rc}")
    launches[fn.kernel] += 1


#: plan-cache lookups in this process, by kernel (the keys of ``launches``),
#: counted by ``plan``: a hit reuses what an earlier call of the same key
#: made, a miss makes it
plan_hits: Dict[str, int] = dict.fromkeys(launches, 0)
plan_misses: Dict[str, int] = dict.fromkeys(launches, 0)
#: keys ``plan`` keeps, the oldest dropped first
MAX_PLANS = 4096
_plans: Dict[tuple, Any] = {}


def plan(key: tuple, make: Callable[[], Any]) -> Any:
    """What ``make()`` returns for ``key``, made on the key's first lookup and
    kept: a wrapper's plan and scalar arguments, which depend only on the
    key.  ``key`` starts with the kernel's name (a key of ``launches``) and
    holds the shapes that decide the plan and the device index.  A ``make``
    that raises keeps nothing, so a bad key raises on every call."""
    made = _plans.get(key)
    if made is None:
        plan_misses[key[0]] += 1
        made = make()
        if len(_plans) >= MAX_PLANS:
            del _plans[next(iter(_plans))]
        _plans[key] = made
    else:
        plan_hits[key[0]] += 1
    return made


def scalars(fn, first: int, *values) -> tuple:
    """``values`` as ctypes objects of the types of the launcher ``fn``'s
    parameters ``first``, ``first + 1``, ...: kept in a plan, they pass
    through each call unconverted."""
    return tuple(ctype(v) for ctype, v in zip(fn.argtypes[first:], values))


def device(t: torch.Tensor, what: str) -> torch.device:
    """``t``'s device, which must be a CUDA device or the CPU: the dispatch
    of every wrapper (CUDA tensors launch the kernel, CPU tensors run the
    plain version).  Else ValueError."""
    if t.is_cuda or t.is_cpu:
        return t.device
    raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")


def check(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype, shape: tuple,
          layout: str = "contiguous") -> None:
    """``t`` is a ``dtype`` tensor of ``shape`` on ``dev``, laid out as
    ``layout`` says: "contiguous", "rows" (a unit last stride, as a row view
    of a larger array has) or "any"; else ValueError."""
    if t.device != dev or t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if layout == "contiguous" and not t.is_contiguous() or layout == "rows" and t.stride(-1) != 1:
        kind = "contiguous" if layout == "contiguous" else "unit last stride"
        raise ValueError(f"{name}: expected a {kind} {dtype} {tuple(shape)} on {dev}, got strides {t.stride()}")


def checks(dev: torch.device, *specs) -> None:
    """Each ``(name, tensor, dtype, shape)`` of ``specs`` a contiguous
    ``dtype`` tensor of ``shape`` on ``dev``, in one pass: a tensor that
    passes costs four attribute reads; the first that fails raises
    ``check``'s ValueError."""
    for name, t, dtype, shape in specs:
        if t.dtype is not dtype or t.shape != shape or t.device != dev or not t.is_contiguous():
            check(name, t, dev, dtype, shape)


def check_table(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype, rows: int, cols: int,
                layout: str = "rows") -> tuple:
    """``t``'s strides, once ``t`` is a ``dtype`` table of ``rows`` rows and at
    least ``cols`` columns on ``dev``, laid out as ``layout`` says (as for
    ``check``): a table that may be wider than a launch reads, such as a row
    view of a tree heap.  Else ``check``'s ValueError."""
    shape, stride = t.shape, t.stride()
    if (t.dtype is not dtype or len(shape) != 2 or shape[0] != rows or shape[1] < cols or t.device != dev
            or layout == "rows" and stride[1] != 1):
        check(name, t, dev, dtype, (rows, max(shape[1], cols) if len(shape) == 2 else cols), layout)
    return stride


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


def _compile(jobs: Dict[str, Tuple[List[str], Path, Path]], log_dir: Path) -> None:
    """Run each ``name -> (compiler and flags, source, library)`` job, all
    started together; each library is written through a temporary file and
    each compiler's output (``nvcc``'s resource report, ``-Xptxas -v``) kept
    in ``log_dir/<name>.log``.  Raises with the logs of the jobs that
    failed."""
    log_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (cmd, source, library) in jobs.items():
        tmp = library.with_suffix(f".{os.getpid()}.tmp")
        with open(log_dir / f"{name}.log", "w") as log:
            procs[name] = (subprocess.Popen([*cmd, "-o", str(tmp), str(source)], stdout=log, stderr=subprocess.STDOUT),
                           tmp, library)
    failed = []
    for name, (proc, tmp, library) in procs.items():
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(tmp, library)
    if failed:
        logs = "\n".join((log_dir / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"the build failed for {failed}:\n{logs}")


def build(names: Iterable[str] = tuple(KERNELS) + tuple(HOST_SOURCES)) -> None:
    """Compile the named libraries that are not built yet, one compiler
    process per source, all started together; logs in ``BUILD_DIR``."""
    todo = [n for n in names if not _library(n).is_file()]
    if todo:
        compilers = {n: _nvcc() if n in KERNELS else _gxx() for n in todo}
        _compile({n: ([compilers[n], *_flags(n)], _source(n), _library(n)) for n in todo}, BUILD_DIR)


def build_variants(out_dir: Path, sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile each ``name -> CUDA source text`` into ``out_dir/<name>.so``
    with the kernels' flags (logs in ``out_dir/<name>.log``) and load each,
    bound to its own text's prototypes, so its launchers go through
    ``launch`` as the package's do: the profiles' variants of a kernel."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
    _compile({n: ([nvcc, *NVCC_FLAGS], out_dir / f"{n}.cu", out_dir / f"{n}.so") for n in sources}, out_dir)
    return {n: bind(ctypes.CDLL(str(out_dir / f"{n}.so")), text) for n, text in sources.items()}


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a CUDA kernel or host source), built first if
    needed; a CUDA library comes bound to its source's prototypes."""
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        _loaded[name] = bind(lib, _source(name).read_text()) if name in KERNELS else lib
    return _loaded[name]
