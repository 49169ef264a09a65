"""The benchmark's spec and what one run carries.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; everything that belongs to one of them sits in a file of its
own that this module finds by the name alone:

- a configuration: the file its ``configs`` entry names
  (``portbench/configs/<config>.json``);
- a traffic mix: ``portbench/traffic/<cell>.json``, whose ``driver`` key
  names the entry the window drives, ``portbench/drivers/<driver>.py``;
- a per-layer metric: ``portbench/metrics/<metric>.py``, whose ``read(run)``
  returns a number or None.

So a cell, a configuration or a metric is added by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, package: Path = PACKAGE) -> ModuleType:
    """A module from a file of ``portbench`` by its path (names such as
    ``idle_share.train.py`` are no Python identifiers)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = f"portbench._by_name.{abs(hash(str(package)))}." + \
        path.relative_to(package).as_posix().replace("/", ".").replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@dataclass(frozen=True)
class Comparison:
    """One number the correctness check compares, and its limit: the run is
    correct only where every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    package: Path = PACKAGE

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    def driver_module(self) -> ModuleType:
        return load_module(self.package / "drivers" / f"{self.driver}.py", self.package)

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.package / "metrics" / f"{metric}.py", self.package)


class Spec:
    """``BENCHMARK.json`` as read from ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str, traffic: Optional[Dict[str, Any]] = None,
             config: Optional[Dict[str, Any]] = None) -> Cell:
        """The cell ``name`` with its configuration, its traffic (``config``
        and ``traffic`` in place of the files', for tests at small sizes) and
        the metrics it reports."""
        work = {w["name"]: w for w in self.data["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in self.data["configs"]}[w["config"]]
        if config is None:
            config = load_json(self.root / conf["file"])
        package = self.root / "portbench"
        if traffic is None:
            traffic = load_json(package / "traffic" / f"{name}.json")
        e2e = [m for m in self.data["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.data["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, end_to_end=e2e,
                    per_layer=layer, package=package)


@dataclass
class Measured:
    """What a driver's window returns: the requests, steps or fits it
    attempted and those that failed, its end-to-end numbers by metric name,
    and what the per-layer readers read (``records``)."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    records: Dict[str, Any] = field(default_factory=dict)


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
