"""The four-card ring cell, staged (``staged/``), on the CPU: its entries
keep the file rules, its readers read made-up traces, and whole runs over
4 gloo ranks at a small size (N = 4096 in all, T = 20) through a
temporary ``BENCHMARK.json``: a sound run is correct, the control and
every fault of the driver are not, and no rank outlives a run.  A run
takes 8-12 s on an 8-core CPU, 3 ranks' start included; its window of
5 s holds some 15 calls, and 32 reference runs keep the spread ratio's
own noise well under its limit."""

import contextlib
import json
import multiprocessing
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from cssm_bench import cell, faults, stage
from cssm_bench.run import Run, execute
from cssm_bench.tests.conftest import RING, SMALL
from cssm_bench.tests.test_bench_files import NAME, UNIT, chip_faults
from cssm_bench.trace import Event, Trace

STAGE = RING
ROOT = Path(__file__).resolve().parents[2]
DRIVER = cell.driver(cell.load_json("traffic", "ring_n2p26")["driver"])


@pytest.fixture(autouse=True)
def no_rank_left():
    """One torch thread in this process, rank 0, while a test runs: with
    the CPU's every core it starves the other ranks and a call takes 2-3 s
    instead of 0.3 (8 cores); and no rank left once it has ended."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    left = multiprocessing.active_children()
    for proc in left:
        proc.kill()
    assert left == []


def _run(tmp_path, fault=None, seconds=5.0):
    """A whole run of the staged cell at its small size; the result line
    and the run."""
    root = stage.write_root(STAGE, tmp_path)
    run = Run(RING, 2 ** 31 + 11, seconds, False, root=root)
    run.traffic.update(SMALL[RING])
    with (faults.planted(run, fault) if fault
          else contextlib.nullcontext()):
        rc = execute(run, need_devices=False)
    assert rc == 0
    return run


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_staged_entries_keep_the_file_rules():
    bench = stage.merged(STAGE)
    chips = {c["name"]: cell.load_json("configs", c["name"])["chips"]
             for c in bench["configs"]}
    assert chip_faults(bench, chips) == []
    w = cell.workload(bench, RING)
    assert w["chips"] == 4 and chips[w["config"]] == 4
    for e in bench["configs"] + bench["workloads"] + bench["per_layer"]:
        for k in ("why", "layer", "source"):
            assert 1 <= len(e.get(k, "x")) <= 200 and "\n" not in e.get(k, "")
    for m in cell.metrics_of(bench, w, per_layer=True):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] == "particle_steps_per_s"
        assert callable(cell.metric(m["name"]).read)
    e2e = [m["name"] for m in cell.metrics_of(bench, w, per_layer=False)]
    assert e2e == ["particle_steps_per_s", "setup_s"]
    cfg = cell.load_json("configs", w["config"])
    flagship = cell.load_json("configs", "seasonal_poisson_d7")
    for k in ("components", "dt", "dtype"):
        assert cfg[k] == flagship[k]
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200


def _made_up_run():
    """Two traced units of 5 steps; card 0 ran an all-reduce, a send/recv
    and a model kernel in a 10 ms window."""
    ms = 1_000_000
    device = [
        Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "kernel", 0,
              1 * ms),
        Event("ncclDevKernel_SendRecv(x)", "kernel", 2 * ms, 4 * ms),
        Event("ncclDevKernel_SendRecv(x)", "kernel", 5 * ms, 6 * ms),
        Event("cssm::gather_kernel", "kernel", 6 * ms, 8 * ms)]
    return types.SimpleNamespace(
        trace=Trace(0, 10 * ms, device, []),
        units=[{"traced": True}] * 2,
        driver=types.SimpleNamespace(steps_per_unit=lambda r: 5))


def test_ring_readers_on_a_made_up_trace():
    run = _made_up_run()
    assert cell.metric("collective_ms_per_step.ring").read(run) == \
        pytest.approx(0.4)
    assert cell.metric("ring_hops_per_step.ring").read(run) == \
        pytest.approx(0.2)
    assert cell.metric("device_idle_pct.ring").read(run) == \
        pytest.approx(40.0)
    run.trace.device = run.trace.device[-1:]
    for name in ("collective_ms_per_step.ring", "ring_hops_per_step.ring"):
        assert cell.metric(name).read(run) is None
    run.trace = None
    assert cell.metric("device_idle_pct.ring").read(run) is None


def test_sound_run_is_correct_and_the_control_is_not(tmp_path, capsys):
    run = _run(tmp_path)
    line = _line(capsys)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 4 and len(run.units) >= 2
    assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}
    limits = run.traffic["limits"]
    numbers = DRIVER.control(run)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", DRIVER.FAULTS)
def test_fault_is_caught(tmp_path, capsys, fault):
    _run(tmp_path, fault=fault)
    line = _line(capsys)
    assert line["correct"] is False, line["checks"]


def test_ring_modules_load_no_jax():
    code = ("import json, sys\n"
            "from cssm_bench import stage\n"
            "from cssm_bench.drivers import ring_calls\n"
            "import composablestatespacemodels_torch.parallel\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax",
                         "composablestatespacemodels_tpu"}


def test_calibration_keeps_the_ranks_for_every_reading(tmp_path, monkeypatch):
    """``stage calibrate`` on the CPU: a sound seed with the control, then
    a fault, the ranks started once and stopped at the end (~25 s)."""
    monkeypatch.setattr(stage._run, "_cache_dirs", lambda root: None)
    out = tmp_path / "cal.json"
    assert stage.main([
        STAGE, "calibrate", "--workload", RING, "--seeds", str(2 ** 31 + 13),
        "--control", "1", "--faults", "counts_coarsened", "--fault-seeds",
        "1", "--seconds", "5", "--set", "n_particles=4096", "n_obs=20",
        "reference_runs=32",
        "--out", str(out), "--cpu"]) == 0
    sound, fault = json.loads(out.read_text())
    limits = cell.load_json("traffic", "ring_n2p26")["limits"]

    def correct(numbers):
        return all(v <= limits[k] for k, v in numbers.items())
    assert correct(sound["numbers"]) and not correct(sound["control"])
    assert fault["fault"] == "counts_coarsened"
    assert not correct(fault["numbers"])
