"""One share of the cores for torch in each pytest-xdist worker.

Each worker would size torch's intra- and inter-op pools to the whole
machine, and the workers together would oversubscribe it.  Importing this
module caps both pools, and ``OMP_NUM_THREADS`` for the processes a test
starts, at ``cpu_count // workers`` threads under xdist, and does nothing
outside it.  ``_torch_parity`` imports it, so under xdist the cap is in
place once collection has imported the port's parity tests, before the
first test runs.
"""

from __future__ import annotations

import os

import torch


def worker_cap(environ=os.environ) -> int | None:
    """Threads for one worker's pools, None outside xdist."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


CAP = worker_cap()
if CAP is not None:
    os.environ["OMP_NUM_THREADS"] = str(CAP)
    torch.set_num_threads(CAP)
    torch.set_num_interop_threads(CAP)
