"""The whole MH iteration's least time on the card over its measured time.

An iteration of all chains is at least their filters' work (that of
``K8_roofline.pmmh``: float32 operations bound it); the proposal and the
accept add ``O(B)`` and are not counted.  The measured time of an
iteration is the traced window over the iterations traced."""

from pathlib import Path

from cssm_bench import roofline
from cssm_bench.cell import load_module

K8 = load_module(Path(__file__).with_name("K8_roofline.pmmh.py"),
                 "cssm_bench.metrics.K8_roofline.pmmh")


def read(run):
    iters = sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)
    if run.trace is None or not run.trace.device or not iters:
        return None
    return roofline.share_pct(K8.least_launch_s(run),
                              run.trace.window_s / iters)
