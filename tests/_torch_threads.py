"""One share of the cores in each pytest-xdist worker: torch's pools and a core mask.

Each worker would size torch's intra- and inter-op pools to the whole
machine, and the workers together would oversubscribe it.  Importing this
module caps both pools, and ``OMP_NUM_THREADS`` for the processes a test
starts, at ``cpu_count // workers`` threads under xdist.

JAX's CPU pools have no size setting, so the cap cannot reach them.  They
do inherit a CPU affinity mask, so the module also pins each worker to a
block of cores of its own (``worker_cores``): every thread that exists at
import, and so every thread and process started after it.  The scheduler
shares time per thread; without the mask a worker running one long Python
callback loop (a Pallas interpret-mode test) waits behind the other
workers' runnable XLA threads.  The cores left over after the blocks go
to no worker.  Outside xdist the module does nothing.

``_torch_parity`` imports it, so under xdist the cap and the mask are in
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


def worker_cores(environ, cores) -> frozenset[int] | None:
    """The block of ``cores`` that worker ``gwK`` owns, None outside xdist.

    With n cores and w workers, k = n // w and worker K owns the K-th
    k sorted cores.  None where there are fewer cores than workers, or
    where the worker's id falls outside the w blocks (xdist numbers a
    worker that replaces a crashed one past them).
    """
    worker = environ.get("PYTEST_XDIST_WORKER", "")
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or not worker.startswith("gw"):
        return None
    cores = sorted(cores)
    w, k, index = int(workers), len(cores) // int(workers), int(worker[2:])
    if k == 0 or index >= w:
        return None
    return frozenset(cores[index * k:(index + 1) * k])


CAP = worker_cap()
if CAP is not None:
    os.environ["OMP_NUM_THREADS"] = str(CAP)
    torch.set_num_threads(CAP)
    torch.set_num_interop_threads(CAP)

START_CORES = frozenset(os.sched_getaffinity(0))
CORES = worker_cores(os.environ, START_CORES)
if CORES is not None:
    pinned: set[str] = set()
    # Again until no thread is new: one started during a pass inherits
    # the mask of a thread that may not have been pinned yet.
    while tids := set(os.listdir("/proc/self/task")) - pinned:
        for tid in tids:
            try:
                os.sched_setaffinity(int(tid), CORES)
            except ProcessLookupError:
                pass  # the thread ended during the loop
        pinned |= tids
