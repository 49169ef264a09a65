"""Builds of a kernel source with parts of its text changed, for the
profiles in this folder: ``sub`` makes a variant's text, ``build`` compiles
every variant with ``nvcc`` (one process a variant, all started together)
and loads each library with ctypes.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

from ae_waveforms_tpu_torch.ops import _build


def sub(src: str, old: str, new: str, count: int = 1) -> str:
    """``src`` with ``old`` replaced by ``new``; raises where ``old`` is not
    found exactly ``count`` times, so a changed kernel source fails loudly."""
    if src.count(old) != count:
        raise RuntimeError(f"the kernel source changed; {old!r} found {src.count(old)} times, not {count}")
    return src.replace(old, new)


def build(out_dir: Path, sources: dict) -> dict:
    """Compile each ``name -> source text`` into ``out_dir/<name>.so`` with
    the kernels' own ``nvcc`` flags; returns ``name -> (library, registers
    per thread by kernel instance)`` from ``nvcc``'s resource report."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        with open(out_dir / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = (out_dir / f"{name}.log").read_text() if proc.wait() == 0 else None
        if log is None:
            raise RuntimeError(f"nvcc failed for {name}:\n{(out_dir / f'{name}.log').read_text()}")
        libs[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), re.findall(r"Used (\d+) registers", log))
    return libs
