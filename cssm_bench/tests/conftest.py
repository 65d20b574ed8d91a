"""Helpers of the benchmark's CPU tests: a cell run in-process at a small
size, with the cell's own files and limits, on the CPU (no look for a
card), optionally with a planted fault."""

from __future__ import annotations

import gc
import math

import pytest

from cssm_bench import cell, faults
from cssm_bench.run import Run, _window, choose_device

LOGLIK = "seasonal_poisson_d7.loglik_n2p24"
ONLINE = "seasonal_poisson_d7.online_n2p22"
PMMH = "negbin_seasonal_d9.pmmh_k8_c256_t1000"
# staged: BENCHMARK.json does not list it yet (cssm_bench/staged/)
RING = "seasonal_poisson_d7_s4.ring_n2p26"

# small sizes of each cell that a CPU test run holds
SMALL = {
    LOGLIK: {"n_particles": 1024, "n_obs": 50},
    ONLINE: {"n_particles": 32768, "n_obs": 2000},
    PMMH: {"n_chains": 64, "n_obs": 50, "iters_per_call": 20,
           "compare_iters": 64},
    RING: {"n_particles": 4096, "n_obs": 20, "reference_runs": 32},
}


def small_run(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 2.0,
              fault: str = None, **over) -> Run:
    """Set up, drive and release a cell at a small size; the check is the
    caller's to make."""
    w = cell.workload(cell.benchmark(), workload)
    traffic = cell.load_json("traffic", w["traffic"])
    traffic.update(SMALL[workload], **over)
    run = Run(workload, seed, seconds, False, traffic=traffic)
    choose_device(run, need_devices=False)
    if fault is None:
        run.driver.setup(run)
        _window(run)
    else:
        with faults.planted(run, fault):
            run.driver.setup(run)
            _window(run)
    run.driver.release(run)
    gc.collect()
    return run


def verdict(run: Run, numbers: dict) -> bool:
    """``correct`` as the run decides it."""
    limits = run.traffic["limits"]
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


@pytest.fixture
def small():
    return small_run
