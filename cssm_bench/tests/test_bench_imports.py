"""What a run loads, in a fresh process: nothing of JAX or of the JAX
package; and the reference loads nothing of the system under test."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_MODULES = """
import json, sys
from cssm_bench import cell, run, calibrate, faults, trace, compare, stats
bench = cell.benchmark()
for w in bench["workloads"]:
    t = cell.load_json("traffic", w["traffic"])
    cell.driver(t["driver"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        cell.metric(m["name"])
import composablestatespacemodels_torch
from composablestatespacemodels_torch.ops import selection
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_MODULES = """
import json, sys
from cssm_bench import compare, roofline, stats
from cssm_bench.reference import model, pf, simulate
from cssm_bench.reference.model import RefModel
from cssm_bench.cell import load_json, benchmark
for c in benchmark()["configs"]:
    RefModel(load_json("configs", c["name"]))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    loaded = _top_levels(RUN_MODULES)
    assert "composablestatespacemodels_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax",
                         "composablestatespacemodels_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _top_levels(REFERENCE_MODULES)
    assert not loaded & {"composablestatespacemodels_torch", "jax", "jaxlib",
                         "flax", "composablestatespacemodels_tpu"}
