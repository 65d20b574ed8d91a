"""The card's peaks and the least time a piece of work needs on it.

Published figures of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense, without sparsity): HBM3 at 3.35 TB/s, 67 TFLOP/s in
float32 outside the tensor cores.  The least time of some work is the
larger of its bytes over the bandwidth and its float32 operations over
the float32 rate.  The work itself is counted from the cell's shapes by
the metric that asks, each input read once and each output written once;
an observation family's density states its own operations
(``reference/obs/<family>.py``).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"
F32 = 4


def peaks(kind: str = DEFAULT) -> dict:
    """The peaks of the card named ``kind`` (the SXM part's for any other
    H100 name)."""
    return PEAKS.get(kind, PEAKS[DEFAULT])


def least_seconds(bytes_moved: float, flops: float,
                  kind: str = DEFAULT) -> float:
    p = peaks(kind)
    return max(bytes_moved / p["bytes_per_s"], flops / p["flops_per_s"])


def density_flops(config: dict) -> int:
    """The float32 operations of one evaluation of the configuration's
    observation density, as its family's reference file states them."""
    from .reference.model import RefModel
    return int(RefModel(config).obs.DENSITY_FLOPS)


def share_pct(least_s: float, measured_s: float):
    """``100 * least / measured``, or None where nothing was measured."""
    if not measured_s or measured_s <= 0.0:
        return None
    return 100.0 * least_s / measured_s
