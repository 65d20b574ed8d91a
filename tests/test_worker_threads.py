"""The cap ``_torch_threads`` puts on torch in each pytest-xdist worker."""

import os

import torch

import _torch_threads


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
