"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

``workloads[name]`` names a configuration (``configs/<config>.json``) and
a traffic mix (``traffic/<traffic>.json``).  The traffic file names its
driver (``drivers/<driver>.py``), the general code that drives one entry
of the system under test with the file's parameters.  Every metric is a
reader of its own, ``metrics/<metric name>.py``.  A later cell or metric
adds files and entries here and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py",
                       f"cssm_bench.drivers.{name}")


def metric(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"cssm_bench.metrics.{name}")


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, per_layer: bool) -> list:
    """The metric entries this cell reports: the per-layer ones that list
    it under ``workloads`` (each lists its cells), or the end-to-end ones
    that list it or list no cells (``setup_s``: every cell)."""
    name = cell["name"]
    if per_layer:
        return [m for m in bench["per_layer"] if name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", (name,))]


def fold(seed: int, *index: int) -> int:
    """A 64-bit seed from ``(seed, index...)``: a call's, a replica's or a
    purpose's own stream."""
    words = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), *index]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)
