"""The benchmark's machinery, driven by data.

Everything that belongs to one cell, configuration, driver or per-layer
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/workloads/<cell>.json``: the cell's driver, its traffic
  parameters, its trace window and the limits of its comparison;
* ``benchmark/drivers/<driver>.py``: what the window drives, with
  ``setup(run)``, ``window(state, seconds)``, ``trace(state)`` and
  ``check(state)``;
* ``benchmark/metrics/<metric>.py``: ``read(facts, trace)``, the metric's
  value from the traced run, or None where it finds nothing to read.

A later change adds a configuration, a cell or a metric by adding such
files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nhans_tpu")


class BenchError(RuntimeError):
    """A cell or file the benchmark cannot run as given."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no {kind[:-1]} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """One run of one cell: what it was asked for and what it found."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    bench: dict             # BENCHMARK.json
    entry: dict             # the cell's entry in it
    workload: dict          # workloads/<cell>.json
    config: dict            # configs/<config>.json
    device: str = "cuda"
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def path(self, rel: str) -> str:
        """A repository path of a data file the configuration names."""
        return os.path.join(ROOT, rel)

    def metrics(self, kind: str) -> List[dict]:
        """The cell's entries of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.bench[kind]
                if self.cell in m.get("workloads", [self.cell])]


def open_run(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Run:
    """The Run of ``cell``, its files read and checked against each other."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == cell]
    if len(entries) != 1:
        raise BenchError(f"no cell {cell!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(os.path.join(HERE, "workloads", f"{cell}.json"))
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                    entry["traffic"]):
        raise BenchError(f"workloads/{cell}.json names another config or "
                         "traffic than BENCHMARK.json")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, files[entry["config"]]))
    return Run(cell, seed, seconds, trace, bench, entry, workload, config,
               device)


def read_per_layer(run: Run, trace) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in run.metrics("per_layer"):
        value = load_module("metrics", m["name"]).read(run.facts, trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def judged(checks: List[dict]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)
