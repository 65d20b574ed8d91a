"""Statistics of the window's host-clock samples."""

from __future__ import annotations

import numpy as np


def latencies_ms(run) -> list:
    """Every untraced unit's wait, hand-off to host read, in ms."""
    return [(u["t1"] - u["t0"]) * 1e3 for u in run.untraced()]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all the values (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
