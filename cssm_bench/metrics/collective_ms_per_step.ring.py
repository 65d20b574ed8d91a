"""Card 0's device time in NCCL kernels (the per-step all-reduces of the
weight scalars, the two all-gathers of the window counts, the ring's
send/recv hops), in ms per traced filter step.  A collective's kernel
runs until every rank has joined it, so this includes the wait for the
slowest rank as well as the transfer.  Kernels matched: every name that
holds ``nccl``; on the H100s (NCCL 2.28.9) ``ncclDevKernel_SendRecv``,
``ncclDevKernel_AllReduce_Sum_u32_RING_LL``,
``ncclDevKernel_AllReduce_Sum_f32_RING_LL`` and
``ncclDevKernel_AllGather_RING_LL``."""

PATTERN = r"(?i)nccl"


def read(run):
    steps = sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)
    if run.trace is None or not steps or not run.trace.kernels(PATTERN):
        return None
    return 1e3 * run.trace.device_seconds(PATTERN) / steps
