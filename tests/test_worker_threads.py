"""The share of the cores ``_torch_threads`` gives each pytest-xdist worker.

Every test here takes well under 0.1 s.
"""

import os

import pytest
import torch

import _torch_threads


def _xdist(worker, workers):
    return {"PYTEST_XDIST_WORKER": f"gw{worker}",
            "PYTEST_XDIST_WORKER_COUNT": str(workers)}


def test_no_cap_outside_xdist():
    assert _torch_threads.worker_cap({}) is None
    assert _torch_threads.worker_cap({"PYTEST_XDIST_WORKER_COUNT": ""}) is None


def test_torch_pools_hold_the_worker_cap():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert _torch_threads.CAP is None
        return
    cap = max(1, (os.cpu_count() or 1) // int(workers))
    assert torch.get_num_threads() == cap
    assert torch.get_num_interop_threads() == cap
    assert os.environ["OMP_NUM_THREADS"] == str(cap)


@pytest.mark.parametrize(
    "environ, cores, expected",
    [(_xdist(k, 6), range(8), frozenset({k})) for k in range(6)]
    + [(_xdist(k, 6), range(12), frozenset({2 * k, 2 * k + 1}))
       for k in range(6)]
    + [(_xdist(1, 6), [7, 3, 11, 5, 9, 1], frozenset({3}))]
    + [(_xdist(k, 6), range(4), None) for k in (0, 5)]
    + [({}, range(8), None),
       ({"PYTEST_XDIST_WORKER_COUNT": "6"}, range(8), None),
       (_xdist(6, 6), range(8), None)],
    ids=[f"8cores-gw{k}" for k in range(6)]
    + [f"12cores-gw{k}" for k in range(6)]
    + ["unsorted-gw1", "4cores-gw0", "4cores-gw5",
       "no-xdist", "no-worker-id", "worker-past-the-blocks"],
)
def test_worker_cores(environ, cores, expected):
    assert _torch_threads.worker_cores(environ, cores) == expected


@pytest.mark.parametrize("n, workers", [(8, 6), (12, 6), (6, 6), (16, 3)])
def test_worker_blocks_are_disjoint_and_cover_with_the_spares(n, workers):
    blocks = [_torch_threads.worker_cores(_xdist(k, workers), range(n))
              for k in range(workers)]
    owned = [core for block in blocks for core in block]
    assert len(owned) == len(set(owned)) == workers * (n // workers)
    spare = set(range(n)) - set(owned)
    assert len(spare) == n % workers
    assert set(owned) | spare == set(range(n))


def test_every_thread_holds_the_worker_mask():
    cores = _torch_threads.worker_cores(os.environ, _torch_threads.START_CORES)
    if "PYTEST_XDIST_WORKER" not in os.environ:
        assert cores is None and _torch_threads.CORES is None
    expected = _torch_threads.START_CORES if cores is None else cores
    assert _torch_threads.CORES == cores
    tids = os.listdir("/proc/self/task")
    masks = {}
    for tid in tids:
        try:
            masks[tid] = frozenset(os.sched_getaffinity(int(tid)))
        except ProcessLookupError:
            pass  # the thread ended since the listing
    assert masks and all(mask == expected for mask in masks.values()), masks
