"""Faults planted under a cell's timed path, to show that its check fails.

Each driver names the faults its cell can have (its ``FAULTS``) and plants
one with its ``planted(run, fault)``, a context manager that replaces one
function of the system under test for the length of a ``with`` block; the
cell's run goes on around it unchanged.  A new driver brings its own, so
nothing here names a driver.  The faults the drivers plant, by name:

* ``state_unchanged``: a step that returns its state unchanged;
* ``half_batch``: half of the batch left out, the rest standing in for it
  (for a filter, half the particle cloud computed and copied into the
  other half);
* ``answer_altered``: an answer altered where it is produced;
* ``accept_shifted``: PMMH's acceptance log-ratio moved by 1 nat.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(run, fault: str):
    """Plant ``fault`` under the timed path of ``run``'s driver."""
    if fault not in getattr(run.driver, "FAULTS", ()):
        raise ValueError(f"no fault {fault!r} for driver "
                         f"{run.traffic['driver']!r}")
    return run.driver.planted(run, fault)


def half_copied(x):
    """``x`` with the second half of its last axis a copy of the first:
    half the particles computed, and the other half filled from them."""
    out = x.clone()
    n = x.shape[-1]
    h = n // 2
    out[..., n - h:] = x[..., :h]
    return out
